"""``Model.chunked_block`` / ``Model.decode_loop`` of the port against the
JAX package's on a paged cache, driven by the same host loop the
``slot_paged`` engine runs: prompts stream in chunk by chunk while other
rows decode K-step blocks, a row joins decode in the dispatch of its
final chunk, and EOS / budget masking happens on the device.  Greedy
tokens must be identical at chunk sizes 1, 4 and 8, with and without an
EOS; the pool contents agree to 2e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PS, P, MAX_LEN, N_PAGES, K = 4, 8, 32, 30, 3
PROMPT_LENS = [7, 12, 3]
MAX_TOKENS = [6, 9, 4]


@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


def _inputs(vocab):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    block = rng.permutation(N_PAGES)[:len(PROMPT_LENS) * P].reshape(
        len(PROMPT_LENS), P).astype(np.int32)
    return prompts, block


class _JaxSide:
    def __init__(self, model, params, shape, block):
        self.m, self.p = model, params
        self.c = {"pages_k": jnp.zeros(shape, jnp.float32),
                  "pages_v": jnp.zeros(shape, jnp.float32),
                  "block": jnp.asarray(block)}
        self.fb = jax.jit(model.chunked_block,
                          static_argnames=("k", "max_len"))
        self.fl = jax.jit(model.decode_loop, static_argnames=("k", "max_len"))

    def chunked(self, chunk, start, nval, cur, pos, rem, eos):
        tok, blk, self.c = self.fb(self.p, self.c, *map(jnp.asarray, (
            chunk, start, nval, cur, pos, rem, eos)), k=K, max_len=MAX_LEN)
        return np.asarray(tok), np.asarray(blk)

    def loop(self, cur, pos, rem, eos):
        blk, self.c = self.fl(self.p, self.c, *map(jnp.asarray, (
            cur, pos, rem, eos)), k=K, max_len=MAX_LEN)
        return np.asarray(blk)

    def pool(self):
        return np.asarray(self.c["pages_k"]), np.asarray(self.c["pages_v"])


class _TorchSide:
    def __init__(self, model, params, shape, block):
        self.m, self.p = model, params
        store = (shape[0] + 1,) + shape[1:]         # + the write-sink page
        self.c = {"pages_k": torch.zeros(store), "pages_v": torch.zeros(store),
                  "block": torch.from_numpy(block)}

    def chunked(self, chunk, start, nval, cur, pos, rem, eos):
        tok, blk, _ = self.m.chunked_block(self.p, self.c, *map(
            torch.from_numpy, (chunk, start, nval, cur, pos, rem, eos)),
            k=K, max_len=MAX_LEN)
        return tok.numpy(), blk.numpy()

    def loop(self, cur, pos, rem, eos):
        blk, _ = self.m.decode_loop(self.p, self.c, *map(
            torch.from_numpy, (cur, pos, rem, eos)), k=K, max_len=MAX_LEN)
        return blk.numpy()

    def pool(self):
        n = self.c["pages_k"].shape[0] - 1
        return self.c["pages_k"][:n].numpy(), self.c["pages_v"][:n].numpy()


def _drive(side, prompts, eos, C):
    """The engine's chunked-admission host loop over one model side.
    Returns (per-row tokens, trace of every dispatch's outputs)."""
    B = len(prompts)
    pf, gen, pos = [0] * B, [0] * B, [0] * B
    cur = np.zeros(B, np.int32)
    outs = [[] for _ in range(B)]
    done = [False] * B
    trace = []
    while not all(done):
        chunk = np.zeros((B, C), np.int32)
        start, nval = np.zeros(B, np.int32), np.zeros(B, np.int32)
        rem, eos_v = np.zeros(B, np.int32), np.full(B, -1, np.int32)
        pos_v = np.array(pos, np.int32)
        finals = set()
        for b in range(B):
            if done[b]:
                continue
            if pf[b] < len(prompts[b]):
                v = min(C, len(prompts[b]) - pf[b])
                chunk[b, :v] = prompts[b][pf[b]:pf[b] + v]
                start[b], nval[b], pos_v[b] = pf[b], v, pf[b] + v
                if pf[b] + v == len(prompts[b]):
                    finals.add(b)
                    rem[b], eos_v[b] = MAX_TOKENS[b] - 1, eos[b]
            else:
                rem[b], eos_v[b] = MAX_TOKENS[b] - gen[b], eos[b]
        if nval.any():
            tok, blk = side.chunked(chunk, start, nval, cur, pos_v, rem,
                                    eos_v)
        else:
            tok, blk = None, side.loop(cur, pos_v, rem, eos_v)
        # A row that carried no chunk gets a garbage next token that
        # nobody reads (the packages compute different garbage): drop it.
        trace.append((None if tok is None else
                      [int(x) if n else None for x, n in zip(tok, nval)],
                      blk.tolist()))
        decoding = [b for b in range(B)
                    if not done[b] and gen[b] > 0]
        for b in range(B):
            if nval[b] == 0:
                continue
            pf[b] += int(nval[b])
            if b in finals:
                t = int(tok[b])
                outs[b].append(t)
                gen[b], pos[b], cur[b] = 1, pf[b], t
                if (t == eos[b] or gen[b] >= MAX_TOKENS[b]
                        or pos[b] + 1 >= MAX_LEN):
                    done[b] = True
                else:
                    decoding.append(b)
        for b in decoding:
            row = blk[b]
            n = int((row >= 0).sum())
            outs[b] += [int(t) for t in row[:n]]
            gen[b] += n
            pos[b] += n
            if n:
                cur[b] = row[n - 1]
            if (n < K or (n and row[n - 1] == eos[b])
                    or gen[b] >= MAX_TOKENS[b] or pos[b] + 1 >= MAX_LEN):
                done[b] = True
    return outs, trace


def _both(pair, C, eos):
    cfg, jm, jp, tm, tp = pair
    prompts, block = _inputs(cfg.vocab_size)
    shape = (N_PAGES, PS, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_)
    js, ts = _JaxSide(jm, jp, shape, block), _TorchSide(tm, tp, shape, block)
    jo, jt = _drive(js, prompts, eos, C)
    to, tt = _drive(ts, prompts, eos, C)
    return (jo, jt, js.pool()), (to, tt, ts.pool())


@pytest.mark.parametrize("C", [1, 4, 8])
def test_chunked_block_greedy_parity(pair, C):
    (jo, jt, jpool), (to, tt, tpool) = _both(pair, C, eos=[-1, -1, -1])
    assert to == jo
    assert tt == jt
    assert [len(o) for o in to] == MAX_TOKENS
    for a, b in zip(tpool, jpool):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("C", [1, 4, 8])
def test_eos_masking_parity(pair, C):
    """Row 1 stops at its third token (chosen as its EOS), on device, in
    both packages; the other rows are unaffected."""
    (free, _, _), _ = _both(pair, C, eos=[-1, -1, -1])
    eos = [-1, free[1][2], -1]
    (jo, jt, jpool), (to, tt, tpool) = _both(pair, C, eos=eos)
    assert to == jo and tt == jt
    assert to[1] == free[1][:free[1].index(eos[1]) + 1]
    assert to[0] == free[0] and to[2] == free[2]
    for a, b in zip(tpool, jpool):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)
