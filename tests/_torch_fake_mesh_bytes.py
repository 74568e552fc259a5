"""Rank 0's bytes of parameters plus optimizer state, as DTensor shards
on a fake 256-rank 16x16 mesh, for the archs named; for
``tests/test_torch_sharding.py``.  A process of its own: it holds the
fake default process group.

  python _torch_fake_mesh_bytes.py OUT.json ARCH...
"""
import json
import sys

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding as sh
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW, OptConfig
from repro_torch.train.train_step import opt_state_shardings, param_shardings


def local_bytes(arch: str, mesh) -> int:
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    opt = AdamW(OptConfig(
        state_dtype="int8" if arch == "arctic-480b" else "float32"))
    with FakeTensorMode(), sh.axis_rules(mesh, cfg.mesh_rules):
        params = model.init(torch.Generator().manual_seed(0))
        state = opt.init(params)
        placed = (tree.map_leaves(sh.distribute, params,
                                  param_shardings(model, mesh)),
                  tree.map_leaves(sh.distribute, state, opt_state_shardings(
                      model, opt, mesh, params)))
        return sum(x.to_local().numel() * x.element_size()
                   for x in tree.flatten(placed)[0])


def main():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = make_production_mesh(device_type="cpu")
    out = {arch: local_bytes(arch, mesh) for arch in sys.argv[2:]}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
