"""The plain references held against the port at SMOKE size in float32
on the CPU: the MoE decoder's final hidden state against
``Model.forward`` (one dispatch, so the capacity rule keeps the
reference's own FIFO choices)."""
import dataclasses

import numpy as np
import torch

from bench.lib import harness, spec, weights, work
from bench.reference.common import strict_f32


def _smoke(cfg_name, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    sizes = harness.sizes_of(cfg)
    ref = spec.reference(spec.config(cfg_name)["reference"])
    W = weights.draw(ref.layout(sizes), 3, "cpu", dtype=torch.float32)
    return build_model(cfg, device="cpu"), sizes, ref, W


def test_moe_decoder_matches_the_port():
    strict_f32()
    model, z, ref, W = _smoke("arctic-480b-2l", "arctic-480b")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        1, z["vocab_size"], 40))
    with torch.no_grad():
        want, _, _ = model.forward(W, tok[None])
        C = work.capacity(len(tok), z["top_k"], z["capacity_factor"],
                          z["num_experts"])

        def route(layer, logits):
            e, _ = ref.top_k(logits, z["top_k"])
            kept = work.fifo_keep(e.numpy(), z["num_experts"], C)
            return e, ref.gates_of(logits, e), torch.from_numpy(kept)

        got = ref.forward(W, z, [tok], route)[0]
    assert torch.allclose(got, want[0], rtol=1e-4, atol=1e-4)
