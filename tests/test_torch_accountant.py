"""The port's per-device accountant (``repro_torch.launch.hlo_analysis``)
against the JAX package's HLO accountant on the same functions, a SMOKE
train step's FLOPs against the reference's analysis of its jitted step,
and one SMOKE dry-run cell on a fake 16x16 process group (a subprocess:
it holds the fake default process group)."""
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

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.train_step import make_train_step as j_step  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.train.optimizer import AdamW, OptConfig  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

HERE = Path(__file__).resolve().parent

jax.config.update("jax_platform_name", "cpu")


def _ref(fn, *args):
    return JH.analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_dot_flops_counted():
    a, b = torch.zeros(128, 256), torch.zeros(256, 64)
    got = H.analyze(lambda a, b: a @ b, a, b).flops
    want = _ref(lambda a, b: a @ b, jnp.zeros((128, 256)), jnp.zeros((256, 64)))
    assert got == pytest.approx(want.flops, rel=0.01)
    assert got == 2 * 128 * 256 * 64


def test_while_trip_multiplication():
    """17 matmuls in a loop: every iteration dispatches, so the count is
    exact; the reference recovers the trip count from the loop."""
    def f(x):
        for _ in range(17):
            x = x @ x
        return x

    got = H.analyze(f, torch.zeros(64, 64)).flops
    want = _ref(lambda a: jax.lax.fori_loop(0, 17, lambda i, x: x @ x, a),
                jnp.zeros((64, 64)))
    assert got == pytest.approx(want.flops, rel=0.05)
    assert got == 17 * 2 * 64 ** 3


def test_scan_over_layers_like_model():
    """The layer stack: 12 stacked weights, one matmul each."""
    def f(h, ws):
        for w in ws:
            h = torch.tanh(h @ w)
        return h

    def jf(x, ws):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)[0]

    got = H.analyze(f, torch.zeros(8, 32), torch.zeros(12, 32, 32)).flops
    want = _ref(jf, jnp.zeros((8, 32)), jnp.zeros((12, 32, 32)))
    assert got == pytest.approx(want.flops, rel=0.05)
    assert got == pytest.approx(12 * 2 * 8 * 32 * 32, rel=0.05)


def test_bytes_reasonable_for_big_matmul():
    """Bytes between the algorithmic minimum and 6x it, as the
    reference's are."""
    a = torch.zeros(512, 512, dtype=torch.bfloat16)
    got = H.analyze(lambda a, b: a @ b, a, a).bytes
    want = _ref(lambda a, b: a @ b, jnp.zeros((512, 512), jnp.bfloat16),
                jnp.zeros((512, 512), jnp.bfloat16)).bytes
    ideal = 3 * 512 * 512 * 2
    assert ideal <= got <= 6 * ideal
    assert ideal <= want <= 6 * ideal


def test_parse_finds_entry():
    calls, entry = H.trace(lambda x: x + 1, torch.zeros(4))
    assert entry is not None and entry in calls and calls[entry]
    comps, jentry = JH.parse_hlo(jax.jit(lambda x: x + 1).lower(
        jnp.zeros((4,))).compile().as_text())
    assert jentry in comps


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_smoke_train_step_flops_match_reference(arch):
    """One SMOKE train step (B=2, T=32, remat "nothing"): per-device FLOPs
    within 10% of the reference's while-aware count of its jitted step."""
    B, T = 2, 32
    jm = jbuild(jsmoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    jo = JAdamW(JOptConfig())
    want = _ref(j_step(jm, jo), jp, jo.init(jp),
                {"tokens": jnp.zeros((B, T), jnp.int32)}).flops
    tm = tbuild(tsmoke(arch), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    to = AdamW(OptConfig())
    got = H.analyze(make_train_step(tm, to), tp, to.init(tp),
                    {"tokens": torch.zeros((B, T), dtype=torch.int32)}).flops
    assert got == pytest.approx(want, rel=0.10), (got, want)


def test_collectives_counted_below_dtensor():
    """A DTensor product on a fake 2x2 mesh: the accountant sees rank 0's
    local shards (a quarter of the global FLOPs, where FlopCounterMode
    counts the global product) and the all-gathers DTensor issues to
    replicate the result.  A subprocess holds the process group."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "from torch.distributed.tensor import distribute_tensor, Shard, "
        "Replicate\n"
        "from repro_torch.launch import hlo_analysis as H\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0, "
        "world_size=4)\n"
        "m = init_device_mesh('cpu', (2, 2), mesh_dim_names=('data', "
        "'model'))\n"
        "a = distribute_tensor(torch.ones(8, 4), m, [Shard(0), Replicate()])\n"
        "b = distribute_tensor(torch.ones(4, 6), m, [Replicate(), Shard(1)])\n"
        "with H.Accountant() as acc:\n"
        "    c = (a @ b).redistribute(m, [Replicate(), Replicate()])\n"
        "print(acc.account.flops, acc.account.collective_counts['all-gather'],"
        " acc.account.collective_bytes['all-gather'])\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent / "src")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    flops, gathers, gbytes = map(float, out.stdout.split()[-3:])
    assert flops == 2 * 8 * 4 * 6 / 4
    assert gathers == 2
    # [4, 3] -> [4, 6] over model, then [4, 6] -> [8, 6] over data.
    assert gbytes == 4 * (4 * 6 + 8 * 6)


@pytest.fixture(scope="module")
def smoke_cell(tmp_path_factory):
    code = (
        "import json, sys\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.models.config import ShapeConfig\n"
        "r = dryrun.dryrun_cell('smollm-135m', ShapeConfig('train_smoke', "
        "'train', 64, 32), smoke=True, rules_override={'heads': None, "
        "'kv_heads': None}, verbose=False)\n"
        "json.dump(r, open(sys.argv[1], 'w'))\n")
    out = tmp_path_factory.mktemp("dryrun") / "cell.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_smoke_dryrun_cell_on_fake_16x16(smoke_cell):
    """The reference's JSON keys; rank 0's argument bytes equal the count
    from the specs; the step ran sharded (collectives planned)."""
    r = smoke_cell
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    for k in ("flops_per_device", "bytes_accessed_per_device",
              "collective_bytes_per_device", "collective_counts", "memory",
              "param_count", "active_param_count"):
        assert k in r
    mem = r["memory"]
    assert mem["argument_bytes"] == mem["argument_bytes_from_specs"] > 0
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    assert r["flops_per_device"] > 0
    assert r["collective_counts"]["all-reduce"] > 0
    assert r["fits"]


def test_smoke_dryrun_flops_are_a_shard_of_the_step(smoke_cell):
    """Per-device FLOPs of the 256-rank plan, against the same SMOKE step
    on one device: the batch of 32 splits 16 ways over data and the MLP
    and vocabulary 16 ways over model, so a device does less than the
    whole step and at least its 1/256."""
    tm = tbuild(tsmoke("smollm-135m"), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    to = AdamW(OptConfig())
    whole = H.analyze(make_train_step(tm, to), tp, to.init(tp),
                      {"tokens": torch.zeros((32, 65),
                                             dtype=torch.int32)}).flops
    per = smoke_cell["flops_per_device"]
    assert whole / 256 <= per < whole
    np.testing.assert_array_less(0, per)

