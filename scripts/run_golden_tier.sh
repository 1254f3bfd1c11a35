#!/usr/bin/env bash
# Golden-parity gate: run the ENTIRE test
# suite including the slow reference-golden tier, so a red golden can never
# ship unnoticed again.
#
#   scripts/run_golden_tier.sh            # everything (fast + slow)
#   scripts/run_golden_tier.sh --fast     # fast tier only (the default gate)
#
# CRASH-PROOFING: a single long pytest process reproducibly dies mid-run on
# this host (SIGABRT/SEGV inside XLA:CPU backend_compile_and_load — see
# tests/conftest.py). So the slow tier runs ONE pytest process PER TEST FILE,
# records each file's exit status, and rolls up a summary. A crashed file is
# retried once (the aborts are intermittent); any file still red/crashed makes
# the gate exit nonzero.
#
# The slow tier re-runs the full CTF / line-profile / reverberation pipelines
# in float64 on CPU (~60-90 min on a 2-core box, warm compile cache). Always
# run this before declaring a round done, with NO concurrent python jobs
# (compile-cache write races are part of the crash history).
set -uo pipefail
cd "$(dirname "$0")/.."

if [[ "${1:-}" == "--fast" ]]; then
    exec env JAX_PLATFORMS=cpu python -m pytest tests/ -q
fi

declare -a RED=()
declare -a CRASHED=()
PASS=0
FAIL=0

run_file() {
    # -m "" overrides pytest.ini's `-m "not slow"` default gate.
    timeout 3600 env JAX_PLATFORMS=cpu python -m pytest "$1" -q -m "" -p no:cacheprovider
}

for f in tests/test_*.py; do
    echo "=== $f ==="
    run_file "$f"
    status=$?
    if [[ $status -ge 128 || $status -eq 124 ]]; then
        echo "--- $f crashed (exit $status), retrying once ---"
        run_file "$f"
        status=$?
    fi
    if [[ $status -eq 0 || $status -eq 5 ]]; then
        # 5 = no tests collected (e.g. file is all fast-tier and already ran)
        PASS=$((PASS + 1))
    elif [[ $status -ge 128 || $status -eq 124 ]]; then
        CRASHED+=("$f (exit $status)")
        FAIL=$((FAIL + 1))
    else
        RED+=("$f (exit $status)")
        FAIL=$((FAIL + 1))
    fi
done

echo
echo "================ GOLDEN TIER ROLL-UP ================"
echo "files green: $PASS   files red/crashed: $FAIL"
if [[ ${#RED[@]} -gt 0 ]]; then
    printf 'RED:     %s\n' "${RED[@]}"
fi
if [[ ${#CRASHED[@]} -gt 0 ]]; then
    printf 'CRASHED: %s\n' "${CRASHED[@]}"
fi
if [[ $FAIL -ne 0 ]]; then
    echo "GOLDEN TIER RED — do not ship." >&2
    exit 1
fi
echo "GOLDEN TIER GREEN."
