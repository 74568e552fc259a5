"""What a served run records for its check: each dispatch's host inputs
and outputs (the rows the engine put in it, their positions, block
tables and tokens) and each expert layer's routing ids, wrapped around
the engine's ``_dispatch`` and the program's ``moe._route`` from the
engine's start.  The ids are copied to ``uint8`` on the device (one small
copy a layer call), with no host sync."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


class Recorder:
    def __init__(self, engine, moe_module, layers: int):
        self.dispatches: List[dict] = []
        self.routes: List[torch.Tensor] = []
        self.layers = layers
        self._moe = moe_module
        self._orig_route = moe_module._route
        orig_dispatch = engine._dispatch

        def route(cfg, x, router_w):
            gates, eids, aux = self._orig_route(cfg, x, router_w)
            self.routes.append(eids.to(torch.uint8))
            return gates, eids, aux

        def dispatch(chunk, start_v, nval_v, pos_v, rem_v, eos_v, k):
            r0 = len(self.routes)
            slots = np.array([-1 if s.request is None else s.request.req_id
                              for s in engine.slots], np.int64)
            bt = engine._block_table()
            try:
                tok, blk = orig_dispatch(chunk, start_v, nval_v, pos_v,
                                         rem_v, eos_v, k)
            except BaseException:
                del self.routes[r0:]
                raise
            self.dispatches.append(dict(
                chunk=chunk, start=start_v.copy(), nval=nval_v.copy(),
                pos=pos_v.copy(), k=int(k), bt=bt, slots=slots, blk=blk,
                r0=r0, r1=len(self.routes)))
            return tok, blk

        moe_module._route = route
        engine._dispatch = dispatch

    def close(self) -> None:
        """Puts the program's routing function back."""
        self._moe._route = self._orig_route
