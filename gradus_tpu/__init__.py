"""gradus_tpu — an accelerator-native, end-to-end differentiable general-relativistic ray tracer.

Built from scratch in JAX (XLA / Pallas / shard_map), with the capabilities of the
Julia reference Gradus.jl (astro-group-bristol/Gradus.jl): spacetime-agnostic geodesic
integration with event detection, black-hole imaging, Cunningham transfer functions,
relativistic line profiles, coronal emissivity, and reverberation lags.

Design stance (vs. the reference, see SURVEY.md):
- rays are a device-resident batch dimension, not a loop;
- Christoffel symbols come from `jax.jacfwd` of the metric components
  (reference: ForwardDiff duals, `src/tracing/method-implementations/auto-diff.jl`);
- the adaptive integrator is a masked fixed-shape `lax.while_loop` over the whole
  ray batch (reference: per-trajectory OrdinaryDiffEq solves on CPU threads);
- event detection (horizon capture / disc intersection) is an array predicate with
  Hermite-interpolant refinement (reference: SciML ContinuousCallback);
- pixel tiles shard across a device mesh via `shard_map`, with `psum` reductions for
  histograms/images.
"""

from gradus_tpu import config as config
from gradus_tpu.config import enable_x64

from gradus_tpu.metrics import (
    KerrMetric,
    SchwarzschildMetric,
    JohannsenMetric,
    JohannsenPsaltisMetric,
    KerrNewmanMetric,
    MorrisThorneWormhole,
    DilatonAxion,
    BumblebeeMetric,
    NoZMetric,
    KerrRefractive,
    KerrDarkMatter,
    SphericalMetric,
    CartesianMetric,
    metric_components,
    metric_4x4,
    inverse_metric_components,
    inner_radius,
)
from gradus_tpu.geodesics import (
    geodesic_equation,
    metric_jacobian,
    constrain,
    constrain_time,
    constrain_all,
    dotproduct,
    propernorm,
    tetradframe,
    lnrframe,
    lnrbasis,
    lowerindices,
    raiseindices,
)
from gradus_tpu.integrate import (
    StatusCodes,
    GeodesicPoint,
    unpack_solution,
    trace_geodesics,
    tracegeodesics,
    Tracer,
    TraceGeodesic,
    TraceRadiativeTransfer,
    trace_radiative_transfer,
    trace_windings,
    domain_upper_hemisphere,
    PoloidalShape,
    event_horizon_chart,
)
from gradus_tpu.geometry import (
    ThinDisc,
    WarpedThinDisc,
    DatumPlane,
    ThickDisc,
    ShakuraSunyaev,
    EllipticalDisc,
    PrecessingDisc,
    PolishDoughnut,
    CompositeGeometry,
)
from gradus_tpu.camera import (
    local_momentum,
    map_impact_parameters,
    LinearGrid,
    GeometricGrid,
    InverseGrid,
    SinGrid,
    CosGrid,
    LogisticGrid,
    PolarPlane,
    CartesianPlane,
    PointFunction,
    FilterPointFunction,
    FilterStatusCode,
    ConstPointFunctions,
    rendergeodesics,
    prerendergeodesics,
    EndpointRenderCache,
    AdaptiveGrid2D,
    adaptive_render,
    adaptive_sky,
    fill_sky_values,
)
from gradus_tpu.orbits import (
    CircularOrbits,
    isco,
    event_horizon,
    ergosphere,
    is_naked_singularity,
    PlungingInterpolation,
    interpolate_plunging_velocities,
)
from gradus_tpu.redshift import (
    redshift_pointfunction,
    interpolate_redshift,
    keplerian_velocity_projector,
)
from gradus_tpu.redshift_analytic import analytic_redshift_pointfunction
from gradus_tpu.transfer import (
    find_offset_for_radius,
    impact_parameters_for_radius,
    cunningham_transfer_function,
    transferfunctions,
    interpolated_transfer_branches,
    TransferBranchGrid,
    integrate_lineprofile,
    integrate_lagtransfer,
    integrate_lagtransfer_timedep,
    closest_approach,
    optimize_for_target,
    impact_parameters_for_target,
    is_visible,
    CunninghamTransferTable,
    make_transfer_function_table,
    LineProfileModel,
)
from gradus_tpu.geometry import MeshAccretionGeometry
from gradus_tpu.lineprofile import lineprofile, TransferFunctionMethod, BinningMethod
from gradus_tpu.corona import (
    LampPostModel,
    BeamedPointSource,
    RingCorona,
    DiscCorona,
    PowerLawSpectrum,
    EvenSampler,
    WeierstrassSampler,
    LowerHemisphere,
    BothHemispheres,
    emissivity_profile,
    tracecorona,
    RadialDiscProfile,
    AnalyticRadialDiscProfile,
    TimeDependentRadialDiscProfile,
    RingCoronaProfile,
    DiscCoronaProfile,
    ring_corona_profile,
    ring_corona_profile_hybrid,
    disc_corona_profile,
)
from gradus_tpu.reverberation import lag_frequency, continuum_time, lagtransfer, binflux

__version__ = "0.1.0"
from gradus_tpu.diff import fwd_adjoint, value_and_grad_fwd, grad_fwd
