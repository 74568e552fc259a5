"""Shared set-up of the port's parity tests: the same seeded weights
through the JAX package and the PyTorch port, at the SMOKE size in
float32 (token-level parity needs f32; CPU bf16 rounds differently in
XLA and torch)."""
import dataclasses

import jax
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model as torch_build_model


def smoke_pair(arch: str = "smollm-135m", seed: int = 0):
    """-> (jax cfg, jax model, jax params, torch model, torch params)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(torch_smoke_config(arch), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = torch_build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm, tp
