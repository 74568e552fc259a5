"""Every reference test has a port counterpart.

A reference test is a ``def test_`` of a ``tests/test_*.py`` file that
is not a port file (``tests/test_torch_*.py``).  Each reference name
needs one of:

- a port case of its own name in some ``tests/test_torch_*.py``;
- an ``ALIASES`` entry naming the port test (``file::name``, a
  parametrised case as ``file::name[id]``) that runs every assertion of
  the reference case against the port, and against ``repro`` where the
  case computes a value; that test's docstring names the reference case;
- an ``EXEMPT`` entry with the reason no port case can exist.

Text only: the files are read, not imported."""
import ast
import functools
import re
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
PORT_PREFIX = "test_torch_"

# reference file -> {reference test: port test that holds it}
ALIASES = {
    "test_core_lockfree.py": {
        "test_fifo_order":
            "test_torch_core.py::test_hostnbb_fifo_and_full_empty",
        "test_wraparound": "test_torch_core.py::test_hostnbb_wraparound",
        "test_spsc_transaction_ids_in_order":
            "test_torch_core.py::test_hostnbb_spsc_threads_in_order",
        "test_racing_threads_single_winner":
            "test_torch_core.py::test_fsm_racing_threads_single_winner",
        "test_mpsc_fan_in":
            "test_torch_core.py::test_mpsc_fan_in_keeps_per_producer_fifo",
    },
    "test_transport.py": {
        "test_fifo_across_wraparound":
            "test_torch_core.py::test_burst_fifo_across_wraparound",
    },
    "test_kernels.py": {
        "test_nbb_matmul_matches_ref":
            "test_torch_nbb.py::test_nbb_matmul_matches_jax",
        "test_nbb_matmul_odd_k_depth":
            "test_torch_nbb.py::test_nbb_matmul_odd_k_depth_matches_jax",
    },
    "test_losses.py": {
        "test_layouts_match_naive":
            "test_torch_losses.py::test_matches_jax_value_and_grad",
    },
    "test_trainer.py": {
        "test_checkpoint_roundtrip":
            "test_torch_train.py::test_checkpoint_roundtrip_with_bf16",
        "test_checkpoint_shape_mismatch":
            "test_torch_train.py::"
            "test_checkpoint_shape_and_structure_mismatch",
        "test_synth_batch_deterministic":
            "test_torch_train.py::test_synth_batch_equals_jax",
        "test_pipeline_delivers_unique_batches":
            "test_torch_train.py::"
            "test_pipeline_delivers_every_batch_once_in_producer_order",
    },
    "test_serve_faults.py": {
        "test_failed_status_is_falsy_with_reason":
            "test_torch_serve_faults.py::test_failed_status_and_knob_validation",
        "test_ctor_validates_robustness_knobs":
            "test_torch_serve_faults.py::test_failed_status_and_knob_validation",
        "test_no_plan_means_no_fault_layer":
            "test_torch_serve_faults.py::test_failed_status_and_knob_validation",
        "test_dispatch_retries_exhausted_fails_slots_keeps_serving":
            "test_torch_serve_faults.py::"
            "test_retries_exhausted_fail_slots_and_keep_serving",
        "test_sync_timeout_is_not_retried":
            "test_torch_serve_faults.py::test_sync_fault_is_not_retried",
        "test_dead_engine_resolves_handles_fast":
            "test_torch_serve_faults.py::"
            "test_dead_engine_resolves_handles_and_tick_is_inert",
        "test_tick_after_death_is_inert":
            "test_torch_serve_faults.py::"
            "test_dead_engine_resolves_handles_and_tick_is_inert",
    },
    "test_serve_overload.py": {
        "test_intake_strict_priority_order":
            "test_torch_overload.py::"
            "test_priority_intake_order_matches_reference[strict]",
        "test_intake_aging_promotes_starved_class":
            "test_torch_overload.py::"
            "test_priority_intake_order_matches_reference[aging]",
        "test_intake_wfq_interleaves_flooding_client":
            "test_torch_overload.py::"
            "test_priority_intake_order_matches_reference[wfq]",
        "test_intake_wfq_weights_bias_service":
            "test_torch_overload.py::"
            "test_priority_intake_order_matches_reference[weights]",
        "test_intake_priorities_off_single_class":
            "test_torch_overload.py::"
            "test_priority_intake_order_matches_reference[one_class]",
        "test_policy_validation":
            "test_torch_overload.py::test_policy_validation_and_shed_status",
        "test_shed_status_is_falsy":
            "test_torch_overload.py::test_policy_validation_and_shed_status",
        "test_pool_preempt_skips_reserved_ahead_pages":
            "test_torch_overload.py::"
            "test_pool_preempt_releases_reserved_ahead_without_copy",
        "test_preemption_requires_paged_scheduler":
            "test_torch_overload.py::test_preemption_refused_outside_slot_paged",
        "test_engine_preempt_resume_byte_identical":
            "test_torch_overload.py::test_preempt_resume_matches_reference",
        "test_engine_preempted_slot_fsm_states":
            "test_torch_overload.py::test_preempt_resume_matches_reference",
        "test_engine_cancel_while_parked":
            "test_torch_overload.py::"
            "test_preempted_fsm_states_and_cancel_while_parked",
        "test_engine_slo_shed":
            "test_torch_overload.py::test_slo_shed_matches_reference",
        "test_engine_no_starvation_under_high_flood":
            "test_torch_overload.py::"
            "test_no_starvation_under_high_flood_matches_reference",
        "test_engine_overload_off_is_unchanged":
            "test_torch_overload.py::test_overload_off_is_unchanged",
    },
    "test_serve_recovery.py": {
        "test_every_boundary_resumes_byte_identical":
            "test_torch_recovery.py::"
            "test_kill_at_every_tick_resumes_byte_identical",
        "test_binds_after_snapshot_replay_deterministically":
            "test_torch_recovery.py::"
            "test_binds_after_the_snapshot_replay_from_the_journal",
        "test_lost_journal_record_fails_typed_not_hangs":
            "test_torch_recovery.py::test_lost_journal_record_fails_typed",
        "test_torn_write_never_corrupts_last_good":
            "test_torch_recovery.py::test_torn_snapshot_and_restore_faults",
        "test_restore_fault_retries_then_gives_up_typed":
            "test_torch_recovery.py::test_torn_snapshot_and_restore_faults",
        "test_config_mismatch_refuses_restore":
            "test_torch_recovery.py::"
            "test_config_or_weights_mismatch_refuses_restore",
        "test_restart_budget_bounds_crash_loops":
            "test_torch_recovery.py::test_restart_budget_bounds_a_crash_loop",
    },
}

# reference file -> {reference test: why no port case can exist}
EXEMPT = {
    "test_pipeline.py": {
        "test_multidevice_worker":
            "jax 0.9.0 raises ShardingTypeError at tests/_multidevice_"
            "worker.py:38, before any comparison, in every run (ROADMAP "
            "section 3); the numerics it leaves unchecked are held in "
            "test_torch_parallel.py through _torch_jax_ring_ref.py",
    },
}


@functools.lru_cache(maxsize=None)
def _names(path: Path) -> tuple:
    """The ``def test_`` names of a file, in order, each once."""
    return tuple(dict.fromkeys(
        re.findall(r"^\s*def (test_\w+)", path.read_text(), re.M)))


def _docstring(path: Path, name: str) -> str:
    """The docstring of the function ``name`` in ``path`` (at any depth:
    a class's method too), or ""."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_docstring(node) or ""
    return ""


def reference_files() -> list:
    return sorted(p.name for p in TESTS.glob("test_*.py")
                  if not p.name.startswith(PORT_PREFIX))


@functools.lru_cache(maxsize=None)
def port_names() -> dict:
    """{port file: its test names}."""
    return {p.name: frozenset(_names(p))
            for p in TESTS.glob(PORT_PREFIX + "*.py")}


def unpaired(ref_file: str, aliases: dict, exempt: dict) -> list:
    """Faults of one reference file's pairing, as readable lines: names
    with no counterpart, aliases to a missing target, a target whose
    docstring does not name the case, aliases for a name that has its
    own port case or no longer exists, exemptions without a reason."""
    port = port_names()
    own = set().union(*port.values())
    names = list(_names(TESTS / ref_file))
    alias, free = aliases.get(ref_file, {}), exempt.get(ref_file, {})
    faults = []
    for name in names:
        if name not in own and name not in alias and name not in free:
            faults.append(f"{name}: no port case, alias or exemption")
    for name, target in alias.items():
        if name not in names:
            faults.append(f"{name}: aliased, but not a test of {ref_file}")
        if name in own:
            faults.append(f"{name}: aliased, but has its own port case")
        file, _, case = target.partition("::")
        func, _, param = case.partition("[")
        if func not in port.get(file, ()):
            faults.append(f"{name}: alias target {target} does not exist")
            continue
        if param and f'"{param[:-1]}"' not in (TESTS / file).read_text():
            faults.append(f"{name}: alias target {target}: no case "
                          f"{param[:-1]!r} in {file}")
        if name not in _docstring(TESTS / file, func):
            faults.append(f"{name}: the docstring of {target} does not "
                          f"name it")
    for name, reason in free.items():
        if name not in names:
            faults.append(f"{name}: exempt, but not a test of {ref_file}")
        if not reason.strip():
            faults.append(f"{name}: exempt without a reason")
    return faults


@pytest.mark.parametrize("ref_file", reference_files())
def test_reference_file_is_paired(ref_file):
    assert unpaired(ref_file, ALIASES, EXEMPT) == []


def test_aliases_and_exemptions_name_reference_files():
    files = set(reference_files())
    assert set(ALIASES) <= files and set(EXEMPT) <= files
