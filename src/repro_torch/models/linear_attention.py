"""Linear attention with data-dependent per-channel decay, the recurrence
both recurrent families share (the JAX package's
``models/linear_attention.py``):

  * Mamba2 / SSD (zamba2): scalar-per-head decay, q=C, k=B, v=dt*x;
  * RWKV-6 "Finch": per-key-channel decay w_t, receptance r as q, bonus u.

Recurrence over a state S_t in R^{N x P} (N key/state channels, P value):

    S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T
    y_t = q_t^T S_t                                  (decay_at_readout)
    y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)        (rwkv)

Two forms of the same function, plain tensor code (no kernel: the
reference leaves both to XLA): :func:`decay_linear_attention_scan`, a
loop over tokens (``hlo_analysis.scan``, which a dry-run plans by its
trip count), and :func:`decay_linear_attention_chunked`, matrix
products within chunks (batched over all chunks) and a loop over chunks
that hands the state on, which separates the decay as exp(L_t - L_s) =
exp(L_t) exp(-L_s) with L the running log-decay sum.  ``ld`` is clamped
to ``[-clamp, 0]`` per step in both, so exp(-L) stays inside the float32
range over a chunk (``clamp * chunk <= 80``).  State and sums are float32;
outputs take v's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.launch.hlo_analysis import scan


def _clamp(ld: torch.Tensor, clamp: float) -> torch.Tensor:
    return torch.clamp(ld, -clamp, 0.0)


def _state0(initial_state: Optional[torch.Tensor], B: int, H: int, N: int,
            P: int, device) -> torch.Tensor:
    if initial_state is None:
        return torch.zeros((B, H, N, P), dtype=torch.float32, device=device)
    return initial_state.float()


def decay_linear_attention_scan(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
    decay_at_readout: bool = True,
    clamp: float = 5.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential form, one token a step (decode, and every call with
    a cache).

    q, k: [B, T, H, N]; v: [B, T, H, P]; ld: [B, T, H, N] log decay
    (<= 0); u: [H, N] bonus (rwkv) or None (mamba).
    Returns y [B, T, H, P] in v's dtype and the final state [B, H, N, P]
    float32."""
    B, T, H, N = q.shape
    P = v.shape[-1]
    decay = torch.exp(_clamp(ld.float(), clamp))[..., None]   # [B,T,H,N,1]
    qf, kf, vf = q.float(), k.float(), v.float()
    consts = () if u is None else (u.float()[None, :, :, None],)

    def step(S, k_t, v_t, q_t, decay_t, *bonus):
        kv = k_t[..., None] * v_t[..., None, :]               # [B,H,N,P]
        if decay_at_readout:
            S = decay_t * S + kv
            read = S
        else:
            read = S + (bonus[0] * kv if bonus else kv)
            S = decay_t * S + kv
        return S, torch.einsum("bhn,bhnp->bhp", q_t, read)

    S, y = scan(step, _state0(initial_state, B, H, N, P, q.device),
                (kf, vf, qf, decay), consts)
    return y.to(v.dtype), S


def decay_linear_attention_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
    decay_at_readout: bool = True,
    chunk: int = 64,
    clamp: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel form: shapes as :func:`decay_linear_attention_scan`,
    ``T % chunk == 0``.  Inside a chunk, decay-scaled q and k meet in one
    masked matrix product; the state is read once per chunk and handed to
    the next.  Every chunk's own products (the masked product, the rwkv
    bonus, each chunk's contribution to the state) run as one batched
    product over all chunks; only the hand-off of the state walks the
    chunks, and each chunk's read of the state it enters with is again
    one product.  Eager PyTorch pays a host launch per operation, and a
    loop over chunks of a dozen operations each left a training step of
    rwkv6-1.6b (64 chunks in each of 24 layers) waiting on the host."""
    B, T, H, N = q.shape
    P = v.shape[-1]
    assert T % chunk == 0, (T, chunk)
    assert clamp * chunk <= 80.0, "decay clamp too loose for f32 exp range"
    C, NC = chunk, T // chunk

    def chunks(x):
        return x.float().reshape(B, NC, C, H, x.shape[-1])

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    ldc = _clamp(chunks(ld), clamp)
    S = _state0(initial_state, B, H, N, P, q.device)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=q.device),
                        0 if decay_at_readout else -1)
    L = torch.cumsum(ldc, dim=2)                        # inclusive, per chunk
    Lq = L if decay_at_readout else L - ldc             # rwkv: pre-decay
    q_in = qc * torch.exp(Lq)
    k_out = kc * torch.exp(-L)
    A = torch.einsum("bcthn,bcshn->bchts", q_in, k_out)
    A = torch.where(causal, A, 0.0)
    y = torch.einsum("bchts,bcshp->bcthp", A, vc)
    if u is not None:
        # The rwkv diagonal: the current token with weight u.
        y = y + (qc * u.float() * kc).sum(-1, keepdim=True) * vc
    Ltot = L[:, :, -1]                                  # [B,NC,H,N]
    k_tail = kc * torch.exp(Ltot[:, :, None] - L)
    kv_tail = torch.einsum("bcthn,bcthp->bchnp", k_tail, vc)
    decay = torch.exp(Ltot)[..., None]                  # [B,NC,H,N,1]
    entering = []
    for decay_c, kv_c in zip(decay.unbind(1), kv_tail.unbind(1)):
        entering.append(S)
        S = decay_c * S + kv_c
    y = y + torch.einsum("bcthn,bchnp->bcthp", q_in,
                         torch.stack(entering, dim=1))
    return y.reshape(B, T, H, P).to(v.dtype), S
