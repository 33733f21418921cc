"""Length-prefixed typed RPC transport of the disaggregated embedding tier
(counterpart of ``repro/runtime/rpc.py``).

The wire format is a framing layer, not a protocol stack: everything above
it (idempotent replay, failover, circuit breaking) lives in
:mod:`repro_torch.runtime.embedding_service`::

    +--------+----------+-----------+------------------+
    | b"EMB1"| u32 hlen | u64 blen  | header | arrays  |
    +--------+----------+-----------+------------------+

``header`` is ``hlen`` bytes of JSON::

    {"kind": "step", "meta": {...},
     "arrays": [{"key": "...", "shape": [...], "dtype": "...",
                 "nbytes": N, "tensor": bool}, ...]}

followed by ``blen`` bytes of raw C-order array data, concatenated in
manifest order.  A frame carries numpy arrays and CPU tensors, and each
arrives as what it was sent as, with the same bits: a numpy array under
its numpy dtype string, a tensor under the same string with ``"tensor":
true``, and a ``torch.bfloat16`` tensor (which numpy has no dtype for) as
its 2-byte bits under the dtype name ``bfloat16``.  A tensor sent under
two keys (an embed table two ops share) travels once: the second entry
names the first in ``"same_as"`` and arrives as the same object.  Every
other value rides the JSON ``meta``.

Robustness properties of this layer alone, as in the reference:

* **Per-call deadlines** -- every receive tracks one wall-clock deadline
  across its partial reads; a lapse raises a typed :class:`RpcTimeout`.
* **Typed error transport** -- a ``kind="err"`` frame names a class from
  :data:`repro_torch.runtime.faults.FAULT_TYPES` and :func:`raise_typed`
  re-raises the same type on the client, so a service-side application
  error is never mistaken for a dead replica.
* **Chaos instrumentation** -- :func:`send_msg` / :func:`recv_msg` fire the
  ``rpc_send`` / ``rpc_recv`` injector sites before touching the socket.

:func:`backoff_delays` is the exponential shape (0, b, 2b, 4b, ...) of
the client's bounded retry and the pool's replica respawn.
"""
from __future__ import annotations

import json
import socket
import struct
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .faults import FAULT_TYPES, RpcError, RpcTimeout

__all__ = ["send_msg", "recv_msg", "raise_typed", "backoff_delays",
           "Deadline", "RpcClient", "RpcError", "RpcTimeout", "frame_bytes"]

MAGIC = b"EMB1"
_HDR = struct.Struct(">4sIQ")

#: frame-size ceilings: a corrupt length prefix must fail fast and typed,
#: not attempt a multi-TiB allocation
MAX_HEADER = 64 << 20
MAX_BODY = 16 << 30

#: the dtype name a bf16 tensor travels under (numpy has no bfloat16)
BF16 = "bfloat16"


def backoff_delays(attempts: int, backoff_s: float) -> Iterator[float]:
    """Attempt k sleeps ``backoff_s * 2**(k-1)`` first (k=0 sleeps
    nothing)."""
    for k in range(attempts):
        yield 0.0 if k == 0 else backoff_s * (2 ** (k - 1))


class Deadline:
    """A wall-clock budget shared across the partial reads of one call."""

    def __init__(self, seconds: Optional[float]):
        self.t_end = None if seconds is None else \
            time.perf_counter() + seconds

    def remaining(self) -> Optional[float]:
        if self.t_end is None:
            return None
        left = self.t_end - time.perf_counter()
        if left <= 0:
            raise RpcTimeout("rpc deadline lapsed")
        return left


def _host_bytes(arr) -> Tuple[np.ndarray, str, bool]:
    """``(bytes view, dtype name, is a tensor)`` of one array to send."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise TypeError(f"rpc frames carry CPU tensors, got one on "
                            f"{arr.device}")
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16, True
        a = t.numpy()
        return a, a.dtype.str, True
    a = np.ascontiguousarray(arr)
    return a, a.dtype.str, False


def _pack(kind: str, meta: Optional[dict], arrays: Optional[dict]
          ) -> Tuple[bytes, list]:
    manifest = []
    bufs = []
    first: dict = {}            # id of a sent object -> its first key
    for key, arr in (arrays or {}).items():
        if id(arr) in first:
            manifest.append({"key": key, "same_as": first[id(arr)]})
            continue
        first[id(arr)] = key
        a, dtype, tensor = _host_bytes(arr)
        manifest.append({"key": key, "shape": list(a.shape),
                         "dtype": dtype, "nbytes": a.nbytes,
                         "tensor": tensor})
        bufs.append(a)
    header = json.dumps({"kind": kind, "meta": meta or {},
                         "arrays": manifest}).encode()
    return header, bufs


def frame_bytes(kind: str, meta: Optional[dict] = None,
                arrays: Optional[dict] = None) -> int:
    """The bytes one frame of these contents puts on the wire."""
    header, bufs = _pack(kind, meta, arrays)
    return _HDR.size + len(header) + sum(b.nbytes for b in bufs)


def send_msg(sock: socket.socket, kind: str, meta: Optional[dict] = None,
             arrays: Optional[dict] = None, *, faults=None) -> None:
    """Frame and send one message.  Any failure surfaces as an ``OSError``
    (the transport class the caller's failover loop catches); the
    ``rpc_send`` chaos site fires first, so a schedule can sever the call
    before a byte moves."""
    if faults is not None:
        faults.fire("rpc_send", kind=kind)
    header, bufs = _pack(kind, meta, arrays)
    body_len = sum(b.nbytes for b in bufs)
    sock.sendall(_HDR.pack(MAGIC, len(header), body_len))
    sock.sendall(header)
    for b in bufs:
        if b.nbytes:
            sock.sendall(memoryview(b.reshape(-1)).cast("B"))


def _recv_exact(sock: socket.socket, n: int, deadline: Deadline) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        sock.settimeout(deadline.remaining())
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 24))
        except socket.timeout as e:
            raise RpcTimeout("rpc deadline lapsed mid-frame") from e
        if not k:
            raise RpcError("connection closed mid-frame")
        got += k
    return buf


def _unpack(entry: dict, raw: bytearray):
    shape = entry["shape"]
    if entry["dtype"] == BF16:
        return torch.frombuffer(raw, dtype=torch.int16).view(
            torch.bfloat16).reshape(shape) if raw else \
            torch.zeros(shape, dtype=torch.bfloat16)
    a = np.frombuffer(raw, dtype=np.dtype(entry["dtype"])).reshape(shape)
    return torch.from_numpy(a) if entry.get("tensor") else a


def recv_msg(sock: socket.socket, *, deadline_s: Optional[float] = None,
             faults=None) -> Tuple[str, dict, dict]:
    """Receive one framed message -> ``(kind, meta, arrays)``.

    Raises :class:`RpcTimeout` when ``deadline_s`` lapses (across partial
    reads, not per chunk) and :class:`RpcError` on framing violations or a
    peer that closed mid-frame.  The ``rpc_recv`` chaos site fires before
    the read, modelling a reply lost on the wire.  Each array owns its
    memory (a writable buffer of its own)."""
    if faults is not None:
        faults.fire("rpc_recv")
    deadline = Deadline(deadline_s)
    magic, hlen, blen = _HDR.unpack(_recv_exact(sock, _HDR.size, deadline))
    if magic != MAGIC:
        raise RpcError(f"bad frame magic {magic!r}")
    if hlen > MAX_HEADER or blen > MAX_BODY:
        raise RpcError(f"frame sizes out of range (header={hlen} "
                       f"body={blen})")
    try:
        header = json.loads(bytes(_recv_exact(sock, hlen, deadline)))
        kind = header["kind"]
        meta = header["meta"]
        manifest = header["arrays"]
    except (ValueError, KeyError, TypeError) as e:
        raise RpcError(f"malformed frame header: {e}") from e
    arrays = {}
    for entry in manifest:
        if "same_as" in entry:
            arrays[entry["key"]] = arrays[entry["same_as"]]
            continue
        raw = _recv_exact(sock, int(entry["nbytes"]), deadline)
        arrays[entry["key"]] = _unpack(entry, raw)
    return kind, meta, arrays


def raise_typed(meta: dict) -> None:
    """Re-raise a service-side error frame as its original fault type."""
    name = meta.get("error", "EmberFault")
    msg = meta.get("msg", "")
    cls = FAULT_TYPES.get(name, RpcError)
    try:
        raise cls(msg)
    except TypeError:
        # multi-arg constructors (MalformedAccessError) degrade to the
        # base fault with the class name kept in the message
        raise FAULT_TYPES["EmberFault"](f"{name}: {msg}") from None


class RpcClient:
    """One connection to one replica: framed calls with per-call deadlines.

    ``call`` is the synchronous convenience; ``send`` / ``recv_reply``
    split the round trip so the executor's submit/result overlap can hide
    the hop (the request leaves at ``submit``, the reply is consumed at
    ``result``)."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: Optional[float] = 5.0, faults=None):
        self.addr = (host, int(port))
        self.timeout_s = timeout_s
        self.faults = faults
        self.sock = socket.create_connection(self.addr, timeout=timeout_s)
        # step frames are small and latency-bound: don't nagle them
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, kind: str, meta: Optional[dict] = None,
             arrays: Optional[dict] = None) -> None:
        send_msg(self.sock, kind, meta, arrays, faults=self.faults)

    def recv_reply(self, deadline_s: Optional[float] = None
                   ) -> Tuple[str, dict, dict]:
        kind, meta, arrays = recv_msg(
            self.sock,
            deadline_s=self.timeout_s if deadline_s is None else deadline_s,
            faults=self.faults)
        if kind == "err":
            raise_typed(meta)
        return kind, meta, arrays

    def call(self, kind: str, meta: Optional[dict] = None,
             arrays: Optional[dict] = None,
             deadline_s: Optional[float] = None) -> Tuple[dict, dict]:
        self.send(kind, meta, arrays)
        _, rmeta, rarrays = self.recv_reply(deadline_s)
        return rmeta, rarrays

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
