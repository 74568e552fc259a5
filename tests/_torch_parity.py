"""Shared set-up of the port's parity tests: the same seeded weights
through the JAX package and the PyTorch port, at the SMOKE size in
float32 (token-level parity needs f32; CPU bf16 rounds differently in
XLA and torch), and the engine helpers the serving parity tests share."""
import dataclasses

import jax
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model as torch_build_model


def smoke_pair(arch: str = "smollm-135m", seed: int = 0, scale: float = 1.0,
               **overrides):
    """-> (jax cfg, jax model, jax params, torch model, torch params).

    ``scale`` multiplies every weight matrix (each leaf of rank >= 2) in
    both packages alike.  At the initializer's own scale the SMOKE model
    echoes its last prompt token forever; at ``scale=3`` its greedy
    streams vary token to token and depend on the whole KV cache, which
    is what a test of moved, parked or restored KV needs.  ``overrides``
    replace fields of both SMOKE configs alike (``num_heads=10``)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               **overrides)
    tcfg = dataclasses.replace(torch_smoke_config(arch), dtype="float32",
                               **overrides)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    if scale != 1.0:
        jp = jax.tree.map(lambda x: x * scale if x.ndim >= 2 else x, jp)
    tm = torch_build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm, tp


def share_jit(eng, donor):
    """Adopt a donor JAX engine's compiled-function caches (identical
    model and shapes), so a many-engine test compiles each trace once."""
    eng._jit_loops = donor._jit_loops
    eng._jit_chunked = donor._jit_chunked
    eng._jit_prefill = donor._jit_prefill
    eng._jit_decode = donor._jit_decode
    eng._jit_write_slot = donor._jit_write_slot
    eng.pool._cow_fns = donor.pool._cow_fns
    eng.pool._swap_fns = donor.pool._swap_fns


def drive(eng, handles, max_ticks: int = 800) -> int:
    """Tick an engine (either package) inline until every handle is
    terminal.  The tick budget is the no-deadlock assertion."""
    ticks = 0
    while not all(h.test() for h in handles):
        ticks += 1
        assert ticks < max_ticks, (
            f"engine wedged: {sum(h.test() for h in handles)}/"
            f"{len(handles)} terminal after {max_ticks} ticks")
        eng.tick()
    return ticks


def pool_clean(eng) -> None:
    """Post-drain pool invariants: every page free or quarantined, no
    sequence left, and the copy ledger balanced exactly."""
    pool = eng.pool
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    assert pool.n_seqs() == 0, pool._tables
    assert pool.used_pages() == len(pool.quarantined)
    assert all(pool.refcount(p) == 1 for p in pool.quarantined)
    assert pool.kv_copy_bytes == (pool.cow_copy_bytes + pool.swap_in_bytes
                                  + pool.swap_out_bytes)


def outcome(handles):
    """(terminal state, tokens, status type) per handle — what two
    engines must agree on."""
    return [(h.response.fsm.state, list(map(int, h.response.tokens_out)),
             type(h.status).__name__ if h.status is not None else None)
            for h in handles]
