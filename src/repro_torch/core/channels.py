"""MCAPI-style communication API: domains, nodes, endpoints, channels.

Reproduces the MCAPI surface the paper refactors (Section 2): three
communication formats over FIFO delivery —

  1) MESSAGES — connection-less, ad-hoc endpoints,
  2) PACKETS  — connection-oriented over established FIFO channels,
  3) SCALARS  — connection-oriented 8/16/32/64-bit values,

backed here by lock-free NBB rings (the paper's refactored design) or by the
mutex-guarded baseline (the reference design) for A/B benchmarking.

The same endpoint naming scheme is reused at the *device* level:
:class:`DeviceChannel` describes a point-to-point edge on a mesh axis and
resolves to the (source, dest) pairs of a collective permute — the
device analogue of an MCAPI FIFO channel.  The descriptor is plain
Python here; ``parallel/pipeline.py`` sends along its pairs, one
point-to-point exchange a tick.
"""
from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import nbw, transport
from repro_torch.core.host_queue import LockedQueue, SpscQueue
from repro_torch.core.transport import (CodecTransport, PriorityTransport,
                                  StateTransport, Transport)


class ChannelType(enum.Enum):
    # MESSAGE delivery is priority FIFO: ``msg_send(payload, priority)``
    # targets one of ``Domain.msg_priorities`` per-class rings (0 = most
    # urgent) and the receiver always serves the lowest-numbered
    # nonempty class first, FIFO within a class (PriorityTransport).
    # Unprioritized ``send`` lands in the least urgent class.
    MESSAGE = "message"   # connection-less, priority FIFO
    PACKET = "packet"     # connected, buffer handoff
    SCALAR = "scalar"     # connected, 8..64-bit values
    STATE = "state"       # NBW: freshest-value, order-indeterminate
    # STATE implements the paper's §7 future work: "enhance the MCAPI
    # runtime to support state message data exchange policies ... we
    # expect to see a speed-up because it drops the FIFO requirement."
    # The writer can never block or fill the channel (NBW non-blocking
    # property); the reader always sees the newest committed value.
    # benchmarks/bench_lockfree.py state_vs_fifo() measures the
    # predicted speed-up.


class Endpoint:
    """An addressable port owned by a node (MCAPI <domain, node, port>)."""

    def __init__(self, domain: int, node: int, port: int):
        self.address = (domain, node, port)
        self.rx: Optional[Any] = None   # receive queue, set when connected

    def __repr__(self):
        return f"Endpoint{self.address}"


@dataclasses.dataclass
class Channel:
    """A one-way connection between two endpoints.

    Every channel type speaks through one :class:`Transport`: the format
    differences (scalar packing, NBW state semantics) are baked into the
    transport stack at :meth:`Domain.connect` time, so send/recv here are
    pure delegation — no per-``ChannelType`` dispatch on the hot path.
    """

    ctype: ChannelType
    send_ep: Endpoint
    recv_ep: Endpoint
    transport: Transport
    queue: Any  # underlying ring/cell (introspection + benchmarks)

    def send(self, payload: Any) -> int:
        return self.transport.send(payload)

    def recv(self) -> Tuple[int, Optional[Any]]:
        return self.transport.try_recv()

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        return self.transport.drain(max_items)

    # -- packet-mode bursts (paper Tables 5-7): one exchange per block -----
    def send_burst(self, vals) -> Tuple[int, int]:
        return self.transport.send_burst(vals)

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        return self.transport.drain_burst(max_n)

    def pkt_send_burst(self, vals) -> Tuple[int, int]:
        """Packet-channel burst — the batched exchange that MCAPI packet
        mode exists for; format-enforced like the other ``pkt_*`` ops."""
        self._require(ChannelType.PACKET, "pkt_send_burst")
        return self.send_burst(vals)

    def pkt_drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        self._require(ChannelType.PACKET, "pkt_drain_burst")
        return self.drain_burst(max_n)

    # -- non-blocking operation handles (MCAPI ``*_i`` variants) -----------
    # send_i/recv_i work on any channel type; the MCAPI-named variants
    # enforce the connection format they are defined for (calling a
    # packet-channel op on a scalar channel is an API error in MCAPI).
    def send_i(self, payload: Any) -> transport.OpHandle:
        return transport.send_i(self.transport, payload)

    def recv_i(self) -> transport.OpHandle:
        return transport.recv_i(self.transport)

    def _require(self, ctype: "ChannelType", op: str) -> None:
        if self.ctype is not ctype:
            raise ValueError(f"{op} on a {self.ctype.value} channel "
                             f"(needs {ctype.value})")

    def msg_send(self, payload: Any,
                 priority: Optional[int] = None) -> int:
        """MESSAGE send with an MCAPI-style priority class (0 = most
        urgent; None = the channel's default, least urgent).  The
        receiver drains classes strict-priority, FIFO within a class —
        the "priority FIFO" the MESSAGE format documents."""
        self._require(ChannelType.MESSAGE, "msg_send")
        if priority is None:
            return self.transport.send(payload)
        return self.transport.send_to(payload, priority)

    def msg_send_i(self, payload: Any,
                   priority: Optional[int] = None) -> transport.OpHandle:
        self._require(ChannelType.MESSAGE, "msg_send_i")
        if priority is None:
            return self.send_i(payload)
        h = transport.OpHandle(
            lambda: (self.transport.send_to(payload, priority), None),
            name="msg_send_i")
        h.test()
        return h

    def msg_recv_i(self) -> transport.OpHandle:
        self._require(ChannelType.MESSAGE, "msg_recv_i")
        return self.recv_i()

    def pkt_send_i(self, payload: Any) -> transport.OpHandle:
        self._require(ChannelType.PACKET, "pkt_send_i")
        return self.send_i(payload)

    def pkt_recv_i(self) -> transport.OpHandle:
        self._require(ChannelType.PACKET, "pkt_recv_i")
        return self.recv_i()

    def scalar_send_i(self, value: int) -> transport.OpHandle:
        self._require(ChannelType.SCALAR, "scalar_send_i")
        return self.send_i(value)

    def scalar_recv_i(self) -> transport.OpHandle:
        self._require(ChannelType.SCALAR, "scalar_recv_i")
        return self.recv_i()

    # -- blocking calls: thin wrappers over handle + wait ------------------
    def send_blocking(self, payload: Any,
                      timeout_s: Optional[float] = None) -> bool:
        return self.send_i(payload).wait(timeout_s=timeout_s)

    def recv_blocking(self, timeout_s: Optional[float] = None) -> Any:
        h = self.recv_i()
        if not h.wait(timeout_s=timeout_s):
            raise TimeoutError("recv_blocking timed out")
        return h.result


def _pack_scalar(value: int) -> bytes:
    # MCAPI scalars are 8/16/32/64-bit; we carry them as 8 bytes.
    return struct.pack("<q", int(value))


def _unpack_scalar(b: bytes) -> int:
    return struct.unpack("<q", b)[0]


class Domain:
    """A communication domain: creates endpoints and connects channels."""

    def __init__(self, domain_id: int = 0, lock_free: bool = True,
                 queue_capacity: int = 64, msg_priorities: int = 4):
        if msg_priorities < 1:
            raise ValueError("need msg_priorities >= 1")
        self.domain_id = domain_id
        self.lock_free = lock_free
        self.queue_capacity = queue_capacity
        self.msg_priorities = msg_priorities
        self._endpoints: Dict[Tuple[int, int, int], Endpoint] = {}
        self.channels: List[Channel] = []

    def create_endpoint(self, node: int, port: int) -> Endpoint:
        key = (self.domain_id, node, port)
        if key in self._endpoints:
            raise ValueError(f"endpoint {key} already exists")
        ep = Endpoint(*key)
        self._endpoints[key] = ep
        return ep

    def connect(self, ctype: ChannelType, send_ep: Endpoint,
                recv_ep: Endpoint, nbw_depth: int = 4) -> Channel:
        """Build the transport stack for this channel type, once.

        Type dispatch happens HERE (connection setup), never per-op:
        STATE gets an NBW cell behind a :class:`StateTransport`; SCALAR
        wraps the ring in a packing :class:`CodecTransport`; MESSAGE
        gets ``msg_priorities`` per-class rings behind a
        :class:`PriorityTransport` (priority FIFO delivery); PACKET
        rides the raw ring, which is already a Transport.
        """
        if ctype is ChannelType.STATE:
            queue: Any = nbw.HostNBW(depth=nbw_depth)
            tp: Transport = StateTransport(queue)
        elif ctype is ChannelType.MESSAGE:
            rings = [SpscQueue(self.queue_capacity) if self.lock_free
                     else LockedQueue(self.queue_capacity)
                     for _ in range(self.msg_priorities)]
            tp = PriorityTransport(rings)
            queue = tp
        else:
            queue = (SpscQueue(self.queue_capacity) if self.lock_free
                     else LockedQueue(self.queue_capacity))
            tp = (CodecTransport(queue, _pack_scalar, _unpack_scalar)
                  if ctype is ChannelType.SCALAR else queue)
        ch = Channel(ctype, send_ep, recv_ep, tp, queue)
        recv_ep.rx = tp
        self.channels.append(ch)
        return ch


# ---------------------------------------------------------------------------
# Device-level channels: FIFO edges over a mesh axis.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceChannel:
    """A point-to-point ring edge along a named mesh axis.

    ``perm(n)`` yields the (source, dest) pairs of a collective permute —
    every member sends to its ``+shift`` neighbour, the device analogue of an
    MCAPI FIFO channel between adjacent cores.
    """

    axis: str
    shift: int = 1

    def perm(self, axis_size: int) -> List[Tuple[int, int]]:
        return [(i, (i + self.shift) % axis_size) for i in range(axis_size)]

    def reverse(self) -> "DeviceChannel":
        return DeviceChannel(self.axis, -self.shift)
