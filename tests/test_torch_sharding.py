"""The port's logical-axis sharding against the JAX package's, on both
production meshes (16x16 and 2x16x16), for every family the port builds:
the parameters' specs, the optimizer state's with ZeRO (float32 and
int8), the batch and KV-cache shardings, and rank 0's bytes of
parameters plus optimizer state on a fake 256-rank mesh.

Neither side needs devices for specs: ``jax.sharding.AbstractMesh`` and
the port's ``AbstractMesh`` carry the names and sizes the rules read.
The local-shard bytes need a process group, so they come from one
subprocess (``tests/_torch_fake_mesh_bytes.py``) on a fake one.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import inputs as jinputs  # noqa: E402
from repro.models.config import SHAPES  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import inputs as tinputs  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train import tree  # noqa: E402

HERE = Path(__file__).resolve().parent
ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return JaxAbstractMesh(shape, names), AbstractMesh(shape, names)


def _jleaves(t, is_leaf=None):
    return jax.tree.leaves(t, is_leaf=is_leaf)


def _tspecs(t):
    return tree.flatten(t, lambda x: isinstance(x, tsh.PartitionSpec))[0]


def _same_specs(jspecs, tspecs):
    jl = [tuple(s) for s in jspecs]
    tl = [tuple(s) for s in tspecs]
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a == b, (i, a, b)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    """``specs_tree(param_axes())`` under the config's mesh_rules, leaf
    by leaf (both trees flatten in sorted-key order)."""
    jm, tm = _meshes(mesh)
    jmodel, tmodel = jbuild(jget(arch)), tbuild(tget(arch), device="cpu")
    with jsh.axis_rules(jm, jget(arch).mesh_rules):
        jspecs = _jleaves(jsh.specs_tree(jmodel.param_axes()),
                          lambda x: isinstance(x, jax.sharding.PartitionSpec))
    with tsh.axis_rules(tm, tget(arch).mesh_rules):
        tspecs = _tspecs(tsh.specs_tree(tmodel.param_axes()))
    _same_specs(jspecs, tspecs)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_congruent_with_init(arch):
    """Every leaf ``init`` draws has an Axes of its rank, in the same
    tree (SMOKE size)."""
    model = tbuild(tsmoke(arch), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    leaves, spec = tree.flatten(params)
    axes, aspec = tree.flatten(model.param_axes(),
                               lambda x: isinstance(x, tsh.Axes))
    assert spec == aspec
    for p, a in zip(leaves, axes):
        assert p.dim() == len(a.names)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_reference(arch, mesh, state_dtype):
    """``state_axes`` + ``zero_shard_spec`` over the whole optimizer
    state (the int8 ``{q, scale}`` form included)."""
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jget(arch), tget(arch)
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jo = jopt.AdamW(jopt.OptConfig(state_dtype=state_dtype))
    to = topt.AdamW(topt.OptConfig(state_dtype=state_dtype))
    with jsh.axis_rules(jm, jcfg.mesh_rules):
        params_abs = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        specs = jsh.specs_tree(jo.state_axes(jmodel.param_axes()))
        state_abs = jax.eval_shape(jo.init, params_abs)
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
        jspecs = [jopt.zero_shard_spec(s, leaf.shape, jm) for s, leaf in
                  zip(_jleaves(specs, is_spec), _jleaves(state_abs))]
    with tsh.axis_rules(tm, tcfg.mesh_rules):
        sh = tts.opt_state_shardings(tmodel, to, tm,
                                     tts.abstract_params(tmodel))
    _same_specs(jspecs, [s.spec for s in tree.flatten(sh)[0]])


def _torch_shapes(specs):
    return [tuple(x.shape) for x in tree.flatten(specs)[0]]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_equal_reference(arch, mesh):
    """``batch_shardings`` on ``train_batch_specs`` (train_4k) and
    ``cache_shardings`` on ``decode_specs``' caches (decode_32k): the
    same shapes, the same specs."""
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jget(arch), tget(arch)
    jmodel, tmodel = jbuild(jcfg), tbuild(tcfg, device="cpu")
    train, decode = SHAPES["train_4k"], SHAPES["decode_32k"]
    jb = jinputs.train_batch_specs(jcfg, train)
    tb = tinputs.train_batch_specs(tcfg, train)
    assert [x.shape for x in _jleaves(jb)] == _torch_shapes(tb)
    _same_specs([s.spec for s in _jleaves(jts.batch_shardings(jm, jb))],
                [s.spec for s in tree.flatten(tts.batch_shardings(tm, tb))[0]])
    jc = jinputs.decode_specs(jcfg, decode, jmodel)["caches"]
    tc = tinputs.decode_specs(tcfg, decode, tmodel)["caches"]
    assert [x.shape for x in _jleaves(jc)] == _torch_shapes(tc)
    _same_specs(
        [s.spec for s in _jleaves(jts.cache_shardings(jm, jc, jcfg))],
        [s.spec for s in tree.flatten(
            tts.cache_shardings(tm, tc, tcfg))[0]])


@pytest.fixture(scope="module")
def fake_mesh_bytes(tmp_path_factory):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = tmp_path_factory.mktemp("bytes") / "bytes.json"
    proc = subprocess.run(
        [sys.executable, str(HERE / "_torch_fake_mesh_bytes.py"), str(out),
         *ARCHS], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return json.loads(out.read_text())


def _ceil_bytes(shape, spec, mesh, itemsize):
    n = itemsize
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        for ax in ((e,) if isinstance(e, str) else (e or ())):
            d = -(-d // mesh.shape[ax])
        n *= d
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_local_bytes_equal_reference_specs(fake_mesh_bytes, arch):
    """Rank 0's bytes of parameters plus optimizer state on 16x16 (int8
    state for arctic-480b, as the dry-runs give it): the port's DTensor
    shards on a fake 256-rank mesh against the count from the JAX
    package's specs and shapes."""
    jm, _ = _meshes("16x16")
    jcfg = jget(arch)
    jmodel = jbuild(jcfg)
    jo = jopt.AdamW(jopt.OptConfig(
        state_dtype="int8" if arch == "arctic-480b" else "float32"))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    with jsh.axis_rules(jm, jcfg.mesh_rules):
        params_abs = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        pspecs = _jleaves(jsh.specs_tree(jmodel.param_axes()), is_spec)
        ospecs = _jleaves(jsh.specs_tree(jo.state_axes(jmodel.param_axes())),
                          is_spec)
        state_abs = jax.eval_shape(jo.init, params_abs)
    want = sum(_ceil_bytes(x.shape, s, jm, x.dtype.itemsize)
               for x, s in zip(_jleaves(params_abs), pspecs))
    want += sum(_ceil_bytes(x.shape, jopt.zero_shard_spec(s, x.shape, jm),
                            jm, x.dtype.itemsize)
                for x, s in zip(_jleaves(state_abs), ospecs))
    assert fake_mesh_bytes[arch] == want


def test_smoke_configs_share_rules_with_reference():
    """The SMOKE configs' mesh_rules (what a SMOKE run under a mesh
    reads) are the JAX package's."""
    for arch in ARCHS:
        assert tsmoke(arch).mesh_rules == jsmoke(arch).mesh_rules


def test_rules_drop_axes_the_mesh_lacks():
    """"pod" leaves "batch" on the single-pod mesh; a mesh axis appears
    at most once in a spec (the later dimension loses it)."""
    for name in MESHES:
        jm, tm = _meshes(name)
        names = ("batch", "seq", "heads", "mlp", "vocab", None, "expert")
        with jsh.axis_rules(jm), tsh.axis_rules(tm):
            assert tuple(jsh.spec_for(names)) == tuple(tsh.spec_for(names))
    with tsh.axis_rules(AbstractMesh((2, 16, 16),
                                     ("pod", "data", "model"))):
        assert tsh.spec_for(("batch", "mlp")) == tsh.P(("pod", "data"),
                                                       "model")
        assert [type(p).__name__ for p in tsh.placements_for(
            ("batch", "mlp"))] == ["Shard", "Shard", "Shard"]


def test_train_mesh_refused_below_256_ranks(capsys):
    """``--mesh single`` needs the 256-rank production mesh; one process
    is refused with a message, before any step."""
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--smoke", "--device", "cpu", "--steps", "1",
                      "--mesh", "single"])
    assert e.value.code == 2
    assert "requires 256 ranks" in capsys.readouterr().err


def test_shard_is_a_noop_outside_rules():
    """Outside a rules context every annotation returns its input, so
    the unsharded numbers stay bit for bit."""
    x = torch.randn(2, 3, 4)
    assert tsh.shard(x, "batch", "seq", "embed") is x
    assert not tsh.active()

