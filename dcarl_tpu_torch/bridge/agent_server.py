"""Planner <-> agent TCP bridge (msgpack), wire-compatible with the
reference's loopback RPC (``dcarl_tpu/bridge/agent_server.py``, on the
port's own msgpack codec, :mod:`dcarl_tpu_torch.bridge.wire`).

In the reference the on-vehicle ROS planner and the RL agent are
separate processes joined by a blocking msgpack-over-TCP round trip per
decision tick: the gym-side server binds and waits
(gym_routing/envs/zzz.py:40-59, port 2345; VEG variant port 2333
returning ``(rl_action, rl_q, rule_q)``), the planner-side client sends
``state + [collision, leave_current_mmap]`` and falls back to the rule
action on any failure (learning.py:38-47, :80-89).

The bridge exists so external planners (a ROS stack, a CARLA loop, a
replay harness) can drive a DCARL policy over the same wire protocol;
``bridge/agent_session.py`` serves the DCARL agent through it.  The
server owns the device: every connection thread calls the one shared
policy (which serialises its ticks).

Differences from the reference, by design:
- server accepts MANY concurrent planner connections (the reference's
  server-mode TODO, learning.py:44-47) — one thread per connection;
- proper streaming unpack (``wire.Unpacker``) instead of assuming
  one message per ``recv``;
- clean shutdown.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional, Sequence

from dcarl_tpu_torch.bridge import wire

LANE_PORT = 2345   # discrete lane-model protocol (zzz.py:32)
VEG_PORT = 2333    # continuous VEG protocol (VEG_planner.py socket)


class AgentServer:
    """Serve ``policy_fn`` over the reference wire protocol.

    ``policy_fn(msg: list[float]) -> int | Sequence[float]`` receives
    the planner's full message (state + trailing flags) and returns
    either a discrete action (lane protocol) or a
    ``(rl_action..., rl_q, rule_q)`` sequence (VEG protocol); the reply
    is msgpack-encoded verbatim.  An exception in ``policy_fn`` ends
    that connection's thread (the client then falls back).
    """

    def __init__(self, policy_fn: Callable, host: str = "127.0.0.1",
                 port: int = 0):
        self._policy = policy_fn
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.address = self._sock.getsockname()
        self._threads = []
        self._closing = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        unpacker = wire.Unpacker()
        with conn:
            while not self._closing.is_set():
                try:
                    chunk = conn.recv(4096)
                except OSError:
                    return
                if not chunk:
                    return
                unpacker.feed(chunk)
                for msg in unpacker:
                    reply = self._policy(msg)
                    if hasattr(reply, "item"):        # 0-d array
                        reply = reply.item()
                    elif isinstance(reply, (list, tuple)):
                        reply = [float(x) for x in reply]
                    else:
                        reply = int(reply)
                    try:
                        conn.sendall(wire.packb(reply))
                    except OSError:
                        return

    def close(self):
        self._closing.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PlannerClient:
    """Planner-side client with the reference's fallback semantics:
    on ANY failure return ``fallback_action`` (the rule action 0 —
    learning.py:88-89)."""

    def __init__(self, host: str = "127.0.0.1", port: int = LANE_PORT,
                 timeout: float = 2.0, fallback_action=0,
                 buffer_size: int = 4096):
        self._addr = (host, port)
        self._timeout = timeout
        self._fallback = fallback_action
        self._buffer = buffer_size
        self._sock: Optional[socket.socket] = None
        self._unpacker = wire.Unpacker()

    def _connect(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(self._timeout)
        s.connect(self._addr)
        self._sock = s

    def decide(self, state: Sequence[float], collision: int = 0,
               leave_mmap: int = 0):
        """One blocking decision round trip:
        send ``state + [collision, leave_mmap]``, return the agent's
        reply (or the fallback on any socket error)."""
        msg = [float(x) for x in state] + [int(collision), int(leave_mmap)]
        try:
            if self._sock is None:
                self._connect()
            self._sock.sendall(wire.packb(msg))
            while True:
                for reply in self._unpacker:
                    return reply
                chunk = self._sock.recv(self._buffer)
                if not chunk:
                    raise ConnectionError("agent closed")
                self._unpacker.feed(chunk)
        except (OSError, ConnectionError):
            self.close()
            return self._fallback

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
