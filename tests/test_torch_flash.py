"""The port's flash attention on the CPU — ``ref.flash_attention_ref`` and
``ops.flash_attention``, which runs it for a CPU tensor — against the JAX
package's Pallas ``flash_attention`` in interpret mode, on the same
numpy-seeded inputs: the cases of ``tests/test_kernels.py`` and
``tests/test_kernels_decode.py`` (MHA, GQA with T < S, hd=128, windows
128/256/512, softcap 50, non-causal, one-token decode at S=512, groups
16:1, 12:4 and 9:3), at 2e-5 in float32 and 3e-2 in bfloat16.  Ragged T
and S, which the Pallas kernel does not accept (it needs S % block_k ==
0 and T % block_q == 0) but the Hopper kernel does, are held against
the JAX package's ``ref.flash_attention_ref``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}

# name: (B, T, S, H, Hkv, hd, kwargs, dtypes)
CASES = {
    "mha_128": (1, 128, 128, 4, 4, 64, {}, ("float32", "bfloat16")),
    "gqa_suffix": (2, 128, 256, 8, 2, 64, {}, ("float32", "bfloat16")),
    "hd128": (1, 256, 256, 6, 3, 128, {}, ("float32", "bfloat16")),
    "window_128": (1, 512, 512, 4, 4, 64, dict(window=128), ("float32",)),
    "window_512": (1, 512, 512, 4, 4, 64, dict(window=512), ("float32",)),
    "softcap_50": (1, 128, 128, 2, 2, 64, dict(softcap=50.0), ("float32",)),
    "noncausal": (1, 128, 256, 4, 4, 64, dict(causal=False), ("float32",)),
    "decode_512": (2, 1, 512, 8, 2, 64, {}, ("float32",)),
    "decode_window_256": (1, 1, 1024, 4, 4, 64, dict(window=256),
                          ("float32",)),
    "gqa_16_1": (1, 128, 128, 16, 1, 64, {}, ("float32",)),
    "gqa_12_4": (1, 128, 128, 12, 4, 64, {}, ("float32",)),
    "gqa_9_3": (1, 128, 128, 9, 3, 64, {}, ("float32",)),
}
RAGGED = {
    "ragged_37_101": (2, 37, 101, 9, 3, 64, {}),
    "ragged_window_softcap": (1, 45, 77, 6, 2, 32,
                              dict(window=20, softcap=30.0)),
    "ragged_noncausal": (1, 3, 70, 4, 1, 16, dict(causal=False)),
    "ragged_decode": (3, 1, 513, 9, 3, 64, {}),
}


def _inputs(seed, B, T, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))


def _port(arrays, dtype, kw):
    """(plain version, ops entry) on CPU tensors of ``dtype``, as f32."""
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in arrays)
    plain = tref.flash_attention_ref(q, k, v, **kw)
    entry = ops.flash_attention(q, k, v, **kw)
    assert entry.dtype == q.dtype
    torch.testing.assert_close(entry, plain, atol=0, rtol=0)
    return plain.float().numpy()


@pytest.mark.parametrize("name,dtype", [(n, d) for n, c in CASES.items()
                                        for d in c[-1]])
def test_matches_pallas_interpret(name, dtype):
    B, T, S, H, Hkv, hd, kw, _ = CASES[name]
    arrays = _inputs(len(name), B, T, S, H, Hkv, hd)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in arrays)
    want = np.asarray(jflash(jq, jk, jv, interpret=True, **kw), np.float32)
    np.testing.assert_allclose(_port(arrays, dtype, kw), want,
                               **TOL[dtype])


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_matches_reference(name):
    B, T, S, H, Hkv, hd, kw = RAGGED[name]
    arrays = _inputs(len(name), B, T, S, H, Hkv, hd)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, arrays),
                                               **kw))
    np.testing.assert_allclose(_port(arrays, "float32", kw), want,
                               **TOL["float32"])


def test_block_q_choice():
    """The wrapper's tiling: g * block_q rows stay within 64 and shared
    memory, block_q never exceeds T."""
    from repro_torch.kernels.flash_attention import block_q_for
    assert block_q_for(512, 3, 10_000) == 16      # the main path: 48 rows
    assert block_q_for(1, 3, 10_000) == 1         # decode: g rows
    assert block_q_for(37, 1, 10_000) == 32
    assert block_q_for(128, 16, 10_000) == 4
    assert block_q_for(128, 3, 20) == 4           # shared memory caps it
