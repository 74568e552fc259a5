"""Core lock-free communication library (the paper's contribution).

Modules:
  nbb        — Non-Blocking Buffer (event messages, SPSC FIFO ring)
  nbw        — Non-Blocking Write protocol (state messages)
  bitset     — lock-free slot allocator (replaces lock-free linked lists)
  refcount   — refcounted lock-free slot allocator (shared KV pages)
  states     — CAS finite-state machines for request/buffer lifecycles
  host_queue — SPSC/MPSC compositions + the lock-based baseline
  transport  — unified send/try_recv/drain protocol + Table-1 backoff
  faults     — seeded fault-injection hooks (inert unless a plan is armed)
  interleave — deterministic-interleaving yield points
  channels   — MCAPI-style domains/nodes/endpoints/channels
"""
from repro_torch.core import (bitset, channels, host_queue,  # noqa: F401
                              nbb, nbw, refcount, states, transport)
