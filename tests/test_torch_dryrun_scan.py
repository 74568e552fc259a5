"""The dry-run's plan of the recurrent families' sequential scan
(``repro_torch.launch.hlo_analysis.scan``) and the accountant's bytes on
fake tensors.

  * An ``Account`` on fake tensors equals the one on real tensors: a
    fake tensor's metadata queries (``prim.device``) touch no memory.
  * A planned scan (one step dispatched, counted T times, its backward
    too) equals the fully dispatched loop: FLOPs, bytes, ``bytes_min``
    and collective counts exactly, the memory peak within 2%.
  * The scan's backward is linear in T, and its outputs and gradients
    equal those of a loop that indexes ``x[:, t]``.
  * SMOKE zamba2/rwkv6 scanning prefill and train FLOPs, planned, within
    10% of the reference's while-aware count of its jitted functions.
  * ``dryrun_cell(smoke=True)`` plans both families' scanning prefill and
    train cells on a fake 16x16 process group (a subprocess: it holds
    the fake default process group).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.train_step import make_train_step as j_step  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.models import linear_attention as tla  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train.optimizer import AdamW, OptConfig  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

HERE = Path(__file__).resolve().parent

jax.config.update("jax_platform_name", "cpu")

FORMS = {"mamba": dict(decay_at_readout=True),
         "rwkv": dict(decay_at_readout=False)}


def _inputs(T, form, B=2, Hh=4, N=16, P=16, grad=True, seed=0):
    """q, k, v, log decay and (rwkv) the bonus u, from a seeded numpy
    generator."""
    r = np.random.default_rng(seed)

    def t(*shape, neg=False):
        a = r.standard_normal(shape).astype(np.float32)
        return torch.tensor(-np.abs(a) if neg else a, requires_grad=grad)

    q, k, v = t(B, T, Hh, N), t(B, T, Hh, N), t(B, T, Hh, P)
    ld = t(B, T, Hh, N, neg=True)
    u = t(Hh, N) if form == "rwkv" else None
    return q, k, v, ld, u


def _scan(q, k, v, ld, u, form, backward):
    y, S = tla.decay_linear_attention_scan(q, k, v, ld, u, **FORMS[form])
    if backward:
        ins = [x for x in (q, k, v, ld, u) if x is not None]
        return (y, S) + torch.autograd.grad(y.sum(), ins)
    return y, S


def _fields(acc):
    a = acc.account
    return (a.flops, a.bytes, a.bytes_min, dict(a.collective_bytes),
            dict(a.collective_counts))


# -- (a) fake tensors count what real tensors count -------------------------

def _einsum_case():
    r = np.random.default_rng(1)
    args = (torch.tensor(r.standard_normal((2, 4, 8)).astype(np.float32)),
            torch.tensor(r.standard_normal((2, 4, 8, 8)).astype(np.float32)))
    return (lambda a, b: torch.einsum("bhn,bhnp->bhp", a, b)), args


def _layer_case():
    cfg = tsmoke("smollm-135m")
    m = tmodel.build_model(cfg, device="cpu")
    lp = tmodel._layer(m.init(torch.Generator().manual_seed(0))["layers"], 0)
    r = np.random.default_rng(2)
    x = torch.tensor(r.standard_normal((2, 16, cfg.d_model)).astype(
        np.float32)).to(cfg.compute_dtype)
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)

    def layer(lp, x, pos):
        return tmodel._block(lp, cfg, x, pos)[0]

    return layer, (lp, x, pos)


def _scan_case(planning):
    def case():
        args = _inputs(8, "rwkv")

        def fn(*a):
            return _scan(*a, "rwkv", backward=True)
        return fn, args, planning
    return case


@pytest.mark.parametrize("case", [
    _einsum_case, _layer_case, _scan_case(False), _scan_case(True)],
    ids=["einsum", "smoke_decoder_layer", "scan_t8", "scan_t8_planned"])
def test_account_on_fake_tensors_equals_real(case):
    """Field by field, and the peak of live bytes too.  A fake tensor's
    ``prim.device`` queries reach the accountant; charged their operands'
    bytes, they made the einsum 10,496 bytes on fake tensors against
    2,560 on real ones."""
    fn, args, *rest = case()
    planning = rest[0] if rest else False
    real = H.Accountant(track_memory=True, planning=planning)
    with real:
        fn(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = torch.utils._pytree.tree_map_only(
            torch.Tensor, lambda t: mode.from_tensor(t).requires_grad_(
                t.requires_grad), args)
        fake = H.Accountant(track_memory=True, planning=planning)
        with fake:
            fn(*fake_args)
    assert _fields(fake) == _fields(real)
    assert fake.peak_bytes == real.peak_bytes
    assert real.account.bytes > 0


def test_metadata_queries_cost_nothing():
    """An operation that returns no tensor reads nothing, but a scalar
    read reads its element."""
    x = torch.ones(4, 4)
    acc = H.Accountant()
    with acc:
        torch.ops.prim.device.default(x)
        torch.ops.aten.sym_size.int(x, 0)
        torch.ops.aten.is_contiguous.default(x)
    assert acc.account.bytes == acc.account.bytes_min == 0
    with acc:
        x[0, 0].item()
    assert acc.account.bytes == acc.account.bytes_min == 4


# -- (b) the planned scan against the dispatched loop ------------------------

@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "fwd_bwd"])
@pytest.mark.parametrize("form", ["mamba", "rwkv"])
@pytest.mark.parametrize("T", [8, 9])
def test_planned_scan_equals_dispatched(T, form, backward):
    """One step counted T times (its backward by classes of steps, the
    unbind's stacks and the bonus's accumulations once) against every
    step dispatched."""
    got = {}
    for planning in (False, True):
        acc = H.Accountant(track_memory=True, planning=planning)
        args = _inputs(T, form, grad=backward)
        with acc:
            out = _scan(*args, form, backward)
            del out
        got[planning] = (_fields(acc), acc.peak_bytes)
    (want, want_peak), (plan, plan_peak) = got[False], got[True]
    assert plan == want
    assert plan_peak == pytest.approx(want_peak, rel=0.02)


def test_plain_loop_without_a_planning_accountant():
    """An accountant that does not plan sees every step dispatched, as
    the serving and training paths run the scan; a planning one sees
    one."""
    counts = {}
    for planning in (False, True):
        acc = H.Accountant(record=True, planning=planning)
        with acc:
            _scan(*_inputs(9, "mamba", grad=False), "mamba", False)
        counts[planning] = sum("bmm" in op.kind for op in acc.ops)
    assert counts == {False: 9, True: 1}


# -- (c) a linear backward, equal to the indexing loop -----------------------

def _indexing_scan(q, k, v, ld, u, decay_at_readout, clamp=5.0):
    """The scan as it indexed ``[:, t]`` in the loop (an oracle: each
    step's backward built a full-length gradient)."""
    B, T, H, N = q.shape
    P = v.shape[-1]
    decay = torch.exp(torch.clamp(ld.float(), -clamp, 0.0))[..., None]
    qf, kf, vf = q.float(), k.float(), v.float()
    bonus = None if u is None else u.float()[None, :, :, None]
    S = torch.zeros((B, H, N, P), dtype=torch.float32)
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        if decay_at_readout:
            S = decay[:, t] * S + kv
            read = S
        else:
            read = S + (kv if bonus is None else bonus * kv)
            S = decay[:, t] * S + kv
        ys.append(torch.einsum("bhn,bhnp->bhp", qf[:, t], read))
    return torch.stack(ys, dim=1).to(v.dtype), S


@pytest.mark.parametrize("form", ["mamba", "rwkv"])
def test_scan_backward_bytes_linear_in_T(form):
    """bytes(4T) - bytes(2T) == 2 (bytes(2T) - bytes(T)) for the forward
    and backward on real tensors; the indexing loop's are quadratic."""
    def nbytes(T, fn):
        q, k, v, ld, u = _inputs(T, form)
        acc = H.Accountant()
        with acc:
            y, _ = fn(q, k, v, ld, u, FORMS[form]["decay_at_readout"])
            torch.autograd.grad(
                y.sum(), [x for x in (q, k, v, ld, u) if x is not None])
        return acc.account.bytes

    def port(q, k, v, ld, u, dr):
        return tla.decay_linear_attention_scan(q, k, v, ld, u,
                                               decay_at_readout=dr)

    b = [nbytes(T, port) for T in (8, 16, 32)]
    assert b[2] - b[1] == 2 * (b[1] - b[0])
    o = [nbytes(T, _indexing_scan) for T in (8, 16, 32)]
    assert o[2] - o[1] > 2 * (o[1] - o[0])


@pytest.mark.parametrize("form", ["mamba", "rwkv"])
def test_scan_equals_the_indexing_loop(form):
    """Outputs, final state and every gradient bit for bit (each gradient
    element gets one non-zero contribution either way)."""
    dr = FORMS[form]["decay_at_readout"]
    got, want = [], []
    for fn, out in ((tla.decay_linear_attention_scan, got),
                    (_indexing_scan, want)):
        q, k, v, ld, u = _inputs(11, form, seed=3)
        y, S = fn(q, k, v, ld, u, decay_at_readout=dr)
        ins = [x for x in (q, k, v, ld, u) if x is not None]
        g = torch.autograd.grad((y * y).sum() + S.sum(), ins)
        out += [y, S, *g]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["mamba", "rwkv"])
def test_chunked_hand_off_equals_the_indexing_loop(form):
    """The chunked form's state hand-off takes each chunk's operands from
    one unbind: outputs and gradients equal those of a copy that indexes
    ``[:, c]``."""
    dr = FORMS[form]["decay_at_readout"]

    def indexing_chunked(q, k, v, ld, u):
        # The chunked form with its hand-off loop spelled with ``[:, c]``.
        real_unbind = torch.Tensor.unbind

        def unbind(x, dim=0):
            return tuple(x.select(dim, i) for i in range(x.shape[dim]))
        torch.Tensor.unbind = unbind
        try:
            return tla.decay_linear_attention_chunked(
                q, k, v, ld, u, decay_at_readout=dr, chunk=4, clamp=1.25)
        finally:
            torch.Tensor.unbind = real_unbind

    got, want = [], []
    for fn, out in ((lambda *a: tla.decay_linear_attention_chunked(
            *a, decay_at_readout=dr, chunk=4, clamp=1.25), got),
            (indexing_chunked, want)):
        q, k, v, ld, u = _inputs(16, form, seed=4)
        y, S = fn(q, k, v, ld, u)
        ins = [x for x in (q, k, v, ld, u) if x is not None]
        g = torch.autograd.grad((y * y).sum() + S.sum(), ins)
        out += [y, S, *g]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- (d) SMOKE scanning cells against the reference's while-aware count ------

B, T_SCAN = 2, 30   # 30 tokens: no multiple of zamba's chunk 8 or rwkv's 4
MAX_LEN = 32
CELLS = [(a, k) for a in ("zamba2-2.7b", "rwkv6-1.6b")
         for k in ("prefill", "train")]


def _ref(fn, *args):
    return JH.analyze(jax.jit(fn).lower(*args).compile().as_text())


@pytest.fixture(scope="module")
def ref_flops(smoke_cells_proc):
    """The reference's FLOPs of a SMOKE cached prefill and train step, per
    family, computed once (lowered on abstract parameters: the count
    needs shapes, not values).  The dry-run subprocess of (e) runs
    meanwhile."""
    out = {}
    tok = jax.ShapeDtypeStruct((B, T_SCAN), jnp.int32)
    for arch in ("zamba2-2.7b", "rwkv6-1.6b"):
        jm = jbuild(jsmoke(arch))
        jo = JAdamW(JOptConfig())
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        out[arch, "train"] = _ref(j_step(jm, jo), jp,
                                  jax.eval_shape(jo.init, jp),
                                  {"tokens": tok}).flops
        out[arch, "prefill"] = _ref(
            lambda p, t: jm.prefill(p, t, MAX_LEN), jp, tok).flops
    return out


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_smoke_scanning_flops_match_reference(ref_flops, arch, kind):
    """The port's plan (one scan step a layer, counted 30 times) within
    10% of the reference's count, whose ``while`` body is multiplied by
    its trip count."""
    tm = tmodel.build_model(tsmoke(arch), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    tok = torch.zeros((B, T_SCAN), dtype=torch.int32)
    acc = H.Accountant(planning=True)
    if kind == "train":
        to = AdamW(OptConfig())
        state = to.init(tp)
        with acc:
            make_train_step(tm, to)(tp, state, {"tokens": tok})
    else:
        with acc, torch.no_grad():
            tm.prefill(tp, tok, MAX_LEN)
    want = ref_flops[arch, kind]
    assert acc.account.flops == pytest.approx(want, rel=0.10), (
        acc.account.flops, want)


# -- (e) SMOKE dry-run cells on a fake 16x16 group ---------------------------

@pytest.fixture(scope="module")
def smoke_cells_proc(tmp_path_factory):
    """Both families' scanning prefill (10 tokens, cached) and train (11
    tokens: no multiple of either chunk) cells, batch 16 over the 16-way
    data axis; the model axis carries nothing (SMOKE widths do not split
    16 ways).  Started here, read by :func:`smoke_cells`."""
    code = (
        "import json, sys\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.models.config import ShapeConfig\n"
        "from repro_torch.parallel.sharding import DEFAULT_RULES\n"
        "rules = {k: None for k, v in DEFAULT_RULES.items() "
        "if v == 'model'}\n"
        "shapes = {'prefill': ShapeConfig('prefill_smoke', 'prefill', 10, "
        "16), 'train': ShapeConfig('train_smoke', 'train', 10, 16)}\n"
        "out = {}\n"
        f"for arch, kind in {CELLS!r}:\n"
        "    out[arch + ':' + kind] = dryrun.dryrun_cell(arch, shapes[kind],"
        " smoke=True, rules_override=rules, verbose=False)\n"
        "json.dump(out, open(sys.argv[1], 'w'))\n")
    path = tmp_path_factory.mktemp("dryrun_scan") / "cells.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen([sys.executable, "-c", code, str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def smoke_cells(smoke_cells_proc):
    proc, path = smoke_cells_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch,kind", CELLS)
def test_smoke_scanning_cell_planned_on_fake_16x16(smoke_cells, arch, kind):
    """Planned, not refused: the reference's keys, rank 0's argument bytes
    equal to the count from the specs, FLOPs and bytes counted, and
    ``0 < bytes_min <= bytes``."""
    r = smoke_cells[f"{arch}:{kind}"]
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    assert r["kind"] == kind
    mem = r["memory"]
    assert mem["argument_bytes"] == mem["argument_bytes_from_specs"] > 0
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    assert r["flops_per_device"] > 0
    assert 0 < r["bytes_min_per_device"] <= r["bytes_accessed_per_device"]
    if kind == "train":
        assert r["collective_counts"]["all-reduce"] > 0
