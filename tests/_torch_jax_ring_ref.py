"""The JAX package's pipeline schedules and compressed all-reduce on 8
forced host devices, for the port's parity test
(``tests/test_torch_parallel.py``).  A subprocess, so the device-count
flag never reaches the test process; it must be set before jax loads.

  python _torch_jax_ring_ref.py DIR

Reads ``DIR/inputs.npz``, writes ``DIR/jax_ring.npz``.  Each pipeline
result is copied to host memory (``np.asarray``) before its stage axis
is indexed: indexing the stage-sharded array itself raises under this
jax version.
"""
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.parallel.compression import compressed_psum  # noqa: E402
from repro.parallel.pipeline import pipeline_apply  # noqa: E402
from repro.parallel.sharding import shard_map_compat  # noqa: E402


def stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def main(d):
    inp = np.load(f"{d}/inputs.npz")
    out = {}
    mesh = jax.make_mesh((8,), ("stage",))
    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    mbs = jnp.asarray(inp["mbs"])
    for schedule in ("barrier", "nbb", "nbb2"):
        res = pipeline_apply(stage_fn, params, mbs, mesh, axis="stage",
                             schedule=schedule)
        out[schedule] = np.asarray(res)[-1]

    dmesh = jax.make_mesh((8,), ("data",))

    def body(g, e):
        mean, new_e = compressed_psum({"w": g[0]}, {"w": e[0]}, "data",
                                      n_shards=8)
        return mean["w"], new_e["w"][None]

    f = shard_map_compat(body, mesh=dmesh, in_specs=(P("data"), P("data")),
                         out_specs=(P(), P("data")))
    g = jnp.asarray(inp["g"])
    mean1, err1 = f(g, jnp.zeros_like(g))
    mean2, _ = f(g, err1)
    out["mean1"] = np.asarray(mean1)
    out["mean2"] = np.asarray(mean2)
    out["err1"] = np.asarray(err1)
    np.savez(f"{d}/jax_ring.npz", **out)


if __name__ == "__main__":
    assert jax.device_count() == 8, jax.device_count()
    main(sys.argv[1])
