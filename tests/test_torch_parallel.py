"""The port's parallelism against the JAX package: the sharded train step,
expert parallelism and re-meshing on gloo worlds of 1 and 2 ranks, the
NBB ring pipeline and the int8 compressed all-reduce on 8 ranks (against
``pipeline_reference`` and against the JAX package's own values on 8
forced host devices), the compression numerics, and the functional
NBB/NBW device cells op by op.

Each gloo world is one spawn per file (``tests/_torch_gloo_worker.py``,
one process per rank); the JAX values come from one subprocess
(``tests/_torch_jax_ring_ref.py``), so its device-count flag never
reaches this process.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # optional dev dependency (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = settings = st = None

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nbb as jnbb  # noqa: E402
from repro.core import nbw as jnbw  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro_torch.core import nbb as tnbb  # noqa: E402
from repro_torch.core import nbw as tnbw  # noqa: E402
from repro_torch.parallel import compression as tcomp  # noqa: E402

HERE = Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")


def _env():
    """The subprocesses' environment: one compute thread each, so eight
    ranks and the JAX side do not oversubscribe the host's cores."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(check: str, world: int, d: Path, timeout: int = 300):
    """Spawn ``world`` gloo ranks running ``check``; -> each rank's
    results."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_gloo_worker.py"), check,
         str(r), str(world), str(port), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(d / f"{check}_{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# gloo worlds of 1 and 2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def step1(tmp_path_factory):
    return run_world("step1", 1, tmp_path_factory.mktemp("step1"))[0]


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
def test_sharded_step_on_host_mesh_equals_unsharded(step1, arch):
    """make_host_mesh() (1x1, gloo world of one): loss and every gradient
    within 2e-5 of the unsharded step (f32)."""
    loss0, loss1 = step1[f"{arch}_loss"]
    assert abs(loss0 - loss1) <= 2e-5 * max(1.0, abs(loss0))
    assert float(step1[f"{arch}_grad_diff"]) <= 2e-5


@pytest.fixture(scope="module")
def ep2(tmp_path_factory):
    return run_world("ep2", 2, tmp_path_factory.mktemp("ep2"))


def test_expert_parallel_block_equals_local(ep2):
    """model = 2: each rank computes 4 of the 8 experts, one all-reduce
    joins them; the same output and aux as the single-device route."""
    for r in ep2:
        assert float(r["block_diff"]) <= 2e-5
        want, got = r["aux"]
        assert abs(want - got) <= 2e-6


def test_expert_parallel_model_loss_and_grads(ep2):
    for r in ep2:
        loss0, loss1 = r["model_loss"]
        assert abs(loss0 - loss1) <= 2e-5 * max(1.0, abs(loss0))
        assert float(r["model_grad_diff"]) <= 2e-5


@pytest.mark.parametrize("key", ["trainer_losses", "dense_trainer_losses"])
def test_remesh_between_meshes_keeps_the_losses(ep2, key):
    """2 steps on each mesh in turn, one Trainer remeshed between them:
    the losses of a Trainer that never had a mesh (MoE: (1, 2), none,
    (1, 2); dense: (2, 1), (1, 2), none)."""
    for r in ep2:
        plain, meshed = r[key]
        np.testing.assert_allclose(meshed, plain, rtol=2e-5, atol=2e-5)


def test_trainer_on_a_mesh_takes_rank_zeros_batches(ep2):
    """Each rank's DataPipeline has its own seed, so the ranks are fed
    different tokens; under model = 2 the Trainer steps on rank 0's
    batches on every rank: the losses of those batches trained with no
    mesh."""
    plain = ep2[0]["fed_plain_losses"]
    for r in ep2:
        np.testing.assert_allclose(r["fed_losses"], plain, rtol=2e-5,
                                   atol=2e-5)


def test_trainer_on_a_mesh_checkpoints_from_rank_zero(ep2):
    """Checkpoints every 2 of 4 steps into one directory: rank 0's writer
    alone saves (its last save is step 4), and a Trainer resumed on the
    mesh on every rank holds the trained state bit for bit."""
    assert list(ep2[1]["fed_saved"]) == []
    assert list(ep2[0]["fed_saved"])[-1] == 4
    for r in ep2:
        assert int(r["resumed_step"]) == 4
        assert float(r["resumed_diff"]) == 0.0


@pytest.mark.parametrize("mesh", ["12", "21"])
def test_adamw_updates_dtensor_leaves_in_row_blocks(ep2, mesh):
    """On (1, 2) and (2, 1): an update of DTensor leaves in row blocks
    (``_CHUNK_ELEMS`` = 7) gives the bits of the whole-leaf update and of
    the plain one, and its float32 temporaries stay within one block."""
    for r in ep2:
        assert float(r[f"adamw{mesh}_blocked_vs_whole"]) == 0.0
        assert float(r[f"adamw{mesh}_blocked_vs_plain"]) == 0.0
        assert 0 < int(r[f"adamw{mesh}_sqrt_bytes"]) <= int(
            r[f"adamw{mesh}_block_bytes"])


# ---------------------------------------------------------------------------
# 8 ranks: the pipeline schedules and the compressed all-reduce
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ring8(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring8")
    rng = np.random.default_rng(0)
    n_stages, n_micro, mb, dim = 8, 12, 4, 16
    np.savez(d / "inputs.npz",
             w=(rng.standard_normal((n_stages, dim, dim)) * 0.3)
             .astype(np.float32),
             b=(rng.standard_normal((n_stages, dim)) * 0.1)
             .astype(np.float32),
             mbs=rng.standard_normal((n_micro, mb, dim)).astype(np.float32),
             g=rng.standard_normal((8, 32, 16)).astype(np.float32))
    jproc = subprocess.Popen(
        [sys.executable, str(HERE / "_torch_jax_ring_ref.py"), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())
    ranks = run_world("ring8", 8, d)
    log = jproc.communicate(timeout=600)[0]
    assert jproc.returncode == 0, log[-4000:]
    return ranks, dict(np.load(d / "jax_ring.npz")), dict(
        np.load(d / "inputs.npz"))


@pytest.mark.parametrize("schedule", ["barrier", "nbb", "nbb2"])
def test_schedule_equals_pipeline_reference(ring8, schedule):
    ranks, _, _ = ring8
    for r in ranks:
        np.testing.assert_allclose(r[schedule], r["want"], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("schedule", ["barrier", "nbb", "nbb2"])
def test_schedule_equals_reference_package(ring8, schedule):
    """The JAX package's pipeline_apply on 8 host devices (copied to host
    before its stage axis is indexed) gives the port's values."""
    ranks, ref, _ = ring8
    np.testing.assert_allclose(ranks[0][schedule], ref[schedule],
                               atol=1e-5, rtol=1e-5)


def test_nbb_moves_a_quarter_of_barrier_bytes(ring8):
    """The paper's point at the collective level, per device: the ring
    sends one activation a tick, the barrier gathers all eight."""
    ranks, _, _ = ring8
    for r in ranks:
        nbb, barrier = float(r["nbb_bytes"]), float(r["barrier_bytes"])
        assert nbb > 0 and nbb * 4 < barrier, (nbb, barrier)
        assert float(r["nbb2_bytes"]) * 4 < barrier


def test_compressed_psum_bounds_and_telescopes(ring8):
    """The JAX worker's bounds: one step within amax/127 of the true
    mean; two steps of the same gradient within 2 amax/127 of twice it."""
    ranks, _, inp = ring8
    g = inp["g"]
    true_mean = g.mean(0)
    amax = float(np.abs(g).max())
    for r in ranks:
        assert np.abs(r["mean1"] - true_mean).max() <= amax / 127 + 1e-6
        np.testing.assert_allclose(r["mean1"] + r["mean2"], 2 * true_mean,
                                   atol=2 * amax / 127 + 1e-5)


def test_compressed_psum_equals_reference_package(ring8):
    """Every rank's mean and its error state, against the JAX package's
    compressed_psum over 8 host devices."""
    ranks, ref, _ = ring8
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["mean1"], ref["mean1"], atol=1e-6)
        np.testing.assert_allclose(r["mean2"], ref["mean2"], atol=1e-6)
        np.testing.assert_allclose(r["err1"], ref["err1"][i], atol=1e-6)


# ---------------------------------------------------------------------------
# compression numerics (one process), against the JAX package
# ---------------------------------------------------------------------------
if st is None:
    def test_quantize_roundtrip_bounded():
        pytest.importorskip("hypothesis")  # records the skip with reason
else:
    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=25, deadline=None)
    def test_quantize_roundtrip_bounded(seed):
        """Round trip within scale/2, and q bit-identical to the JAX
        package's (both round half to even)."""
        x = np.random.default_rng(seed).standard_normal(64).astype(
            np.float32)
        q, scale = tcomp.quantize_int8(torch.from_numpy(x))
        recon = tcomp.dequantize_int8(q, scale)
        assert np.abs(x - recon.numpy()).max() <= float(scale) / 2 + 1e-7
        jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)


def test_quantize_half_rounds_to_even():
    """Ties land on the even integer in both packages (x = k + 0.5 at
    scale 1)."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.0], np.float32)
    q, _ = tcomp.quantize_int8(torch.from_numpy(x))
    jq, _ = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q.numpy(), [0, 2, 2, 0, -2, 127])


def test_quantize_zero_tensor():
    q, scale = tcomp.quantize_int8(torch.zeros(8))
    assert float(scale) == 1.0
    assert (q == 0).all()


def test_error_feedback_telescopes():
    """sum of k compressed steps -> k*g with O(1) (not O(k)) error, and
    every step's payload the JAX package's."""
    g0 = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    g, jg = {"w": torch.from_numpy(g0)}, {"w": jnp.asarray(g0)}
    err, jerr = tcomp.init_error_state(g), jcomp.init_error_state(jg)
    total = torch.zeros(128)
    k = 20
    for _ in range(k):
        comp, err = tcomp.compress_grads(g, err)
        jcompd, jerr = jcomp.compress_grads(jg, jerr)
        np.testing.assert_array_equal(comp["w"]["q"].numpy(),
                                      np.asarray(jcompd["w"]["q"]))
        total = total + tcomp.decompress_grads(comp)["w"]
    scale = float(np.abs(g0).max()) / 127.0
    resid = np.abs(total.numpy() - k * g0).max()
    assert resid <= scale + 1e-6, (resid, scale)


def test_compression_ratio():
    g = {"w": torch.zeros(1024)}
    comp, _ = tcomp.compress_grads(g, tcomp.init_error_state(g))
    raw = 1024 * 4
    packed = comp["w"]["q"].numel() * 1 + 4
    assert packed * 3 < raw
    assert comp["w"]["q"].dtype == torch.int8


# ---------------------------------------------------------------------------
# functional NBB / NBW device cells, op by op against the JAX package
# ---------------------------------------------------------------------------
def _nbb_run(ops, capacity, device="cpu"):
    """Apply (is_insert, value) ops to both packages' NBBState; assert
    items, statuses and counters equal after every op."""
    s = tnbb.init(capacity, torch.zeros(3, device=device))
    js = jnbb.init(capacity, jnp.zeros(3))
    for insert, val in ops:
        item = np.full(3, val, np.float32)
        if insert:
            s, st_ = tnbb.insert_item(s, torch.from_numpy(item).to(device))
            js, jst = jnbb.insert_item(js, jnp.asarray(item))
        else:
            s, got, st_ = tnbb.read_item(s)
            js, jgot, jst = jnbb.read_item(js)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          np.asarray(jgot))
        assert int(st_) == int(jst)
        assert st_.dtype == torch.int32
        assert int(s.update_count) == int(js.update_count)
        assert int(s.acknowledge_count) == int(js.acknowledge_count)
        assert int(tnbb.size(s)) == int(jnbb.size(js))
        np.testing.assert_array_equal(s.slots.cpu().numpy(),
                                      np.asarray(js.slots))


def _nbw_run(ops, depth):
    s = tnbw.init(depth, torch.zeros(2))
    js = jnbw.init(depth, jnp.zeros(2))
    for write, val in ops:
        if write:
            v = np.full(2, val, np.float32)
            s, js = tnbw.write(s, torch.from_numpy(v)), jnbw.write(
                js, jnp.asarray(v))
        got, ver = tnbw.read(s)
        jgot, jver = jnbw.read(js)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
        assert int(ver) == int(jver)
        assert int(s.version) == int(js.version)


def test_nbb_fill_drain_statuses():
    """Fill past full (one BUFFER_FULL), drain past empty (one
    BUFFER_EMPTY)."""
    ops = [(True, i + 1) for i in range(5)] + [(False, 0)] * 6
    _nbb_run(ops, capacity=4)


if st is None:
    def test_nbb_ops_match_reference():
        pytest.importorskip("hypothesis")

    def test_nbw_ops_match_reference():
        pytest.importorskip("hypothesis")
else:
    @given(st.integers(1, 5), st.lists(
        st.tuples(st.booleans(), st.integers(-50, 50)), max_size=24))
    @settings(max_examples=30, deadline=None)
    def test_nbb_ops_match_reference(capacity, ops):
        _nbb_run(ops, capacity)

    @given(st.integers(1, 4), st.lists(
        st.tuples(st.booleans(), st.integers(-50, 50)), max_size=16))
    @settings(max_examples=30, deadline=None)
    def test_nbw_ops_match_reference(depth, ops):
        _nbw_run(ops, depth)
