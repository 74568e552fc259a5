"""The whole forward's share of the card's bf16 peak over the window:
the useful model FLOPs of the prompt positions the engine computed (the
real ones, not the left padding nor the adopted ones) and of every
output token, over the window's seconds.  A token's FLOPs: twice the
parameters that multiply it in each layer (attention projections, the
dense residual MLP, the router, top-k experts), twice the LM head's for
an output token, and attention over its context, 4 hd H per key."""
from bench.lib import peaks

DRIVER, UNIT, SOURCE = "serve", "%", "host_clock"
LAYER = "model dispatch (models/model.py)"
MOVES = "output_tokens_per_s"


def per_layer_params(z):
    d, H, Hkv, hd = z["d_model"], z["num_heads"], z["num_kv_heads"], \
        z["head_dim"]
    attn = d * (H + 2 * Hkv) * hd + H * hd * d
    dense = 3 * d * z["d_ff"] if z.get("dense_residual") else 0
    return attn + dense + d * z["num_experts"] \
        + z["top_k"] * 3 * d * z["d_ff_expert"]


def read(ctx):
    z = ctx["sizes"]
    L, d, V = z["num_layers"], z["d_model"], z["vocab_size"]
    dense = 2 * L * per_layer_params(z)
    attn = 4 * z["head_dim"] * z["num_heads"] * L
    flops = ((ctx["computed_prompt_tokens"] + ctx["output_tokens"]) * dense
             + ctx["output_tokens"] * 2 * d * V
             + attn * ctx["attended_keys"])
    return 100.0 * flops / ctx["window_s"] / peaks.BF16_FLOPS
