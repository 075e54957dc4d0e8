"""ICMP echo RTT measurement with graceful degradation.

Counterpart of the reference's ``utils/ping.py``.

The upstream probes hosts with privileged ICMP pings (upstream
pkg/net/ping/ping.go: one echo, 1s timeout, SetPrivileged(true)); the
daemon's prober feeds those RTTs into the scheduler's SyncProbes stream.
This module measures the same signal three ways, best available first:

1. raw ICMP socket (needs CAP_NET_RAW / root — the upstream's mode),
2. ICMP datagram socket (Linux unprivileged ping, when
   ``net.ipv4.ping_group_range`` allows),
3. caller-side fallback (the daemon falls back to a TCP connect RTT —
   same latency signal, needs an open port instead of privileges).

A per-host rate limit (``min_interval``) bounds echo traffic: probing
re-measures a host at most once per interval and serves the cached RTT
in between, so N concurrent tasks probing one parent can't turn the
prober into a ping flood.
"""

from __future__ import annotations

import os
import random
import socket
import struct
import threading
import time

from dragonfly2_torch.utils import dflog

logger = dflog.get("ping")

ICMP_ECHO_REQUEST = 8
ICMP_ECHO_REPLY = 0
DEFAULT_TIMEOUT = 1.0  # upstream defaultPingTimeout
DEFAULT_MIN_INTERVAL = 1.0  # per-host echo budget


def _checksum(data: bytes) -> int:
    """RFC 1071 16-bit ones'-complement sum."""
    if len(data) % 2:
        data += b"\x00"
    total = 0
    for (word,) in struct.iter_unpack("!H", data):
        total += word
        total = (total & 0xFFFF) + (total >> 16)
    return (~total) & 0xFFFF


def _build_echo(ident: int, seq: int) -> bytes:
    payload = struct.pack("!d", time.time()) + b"df-ping-pad-----"
    header = struct.pack("!BBHHH", ICMP_ECHO_REQUEST, 0, 0, ident, seq)
    csum = _checksum(header + payload)
    return struct.pack("!BBHHH", ICMP_ECHO_REQUEST, 0, csum, ident, seq) + payload


def _open_icmp_socket() -> tuple[socket.socket, bool] | None:
    """(socket, is_raw) or None when neither mode is permitted."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_RAW, socket.IPPROTO_ICMP)
        return s, True
    except PermissionError:
        pass
    except OSError:
        return None
    try:
        # Linux unprivileged ping: kernel manages the identifier
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_ICMP)
        return s, False
    except OSError:
        return None


def icmp_ping(addr: str, timeout: float = DEFAULT_TIMEOUT) -> float | None:
    """One ICMP echo RTT in seconds; None on timeout/unreachable/no
    privileges. Raw-socket mode matches replies on (source, id, seq) —
    a raw socket sees every ICMP packet on the host, so unrelated
    replies must be skipped, not misread."""
    opened = _open_icmp_socket()
    if opened is None:
        return None
    sock, is_raw = opened
    ident = (os.getpid() ^ random.getrandbits(16)) & 0xFFFF
    seq = random.getrandbits(15)
    try:
        sock.settimeout(timeout)
        try:
            dest_ip = socket.gethostbyname(addr)
        except OSError:
            return None
        t0 = time.monotonic()
        sock.sendto(_build_echo(ident, seq), (dest_ip, 0))
        deadline = t0 + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            sock.settimeout(remaining)
            try:
                packet, src = sock.recvfrom(2048)
            except socket.timeout:
                return None
            rtt = time.monotonic() - t0
            icmp = packet
            if is_raw:
                if src[0] != dest_ip:
                    continue
                if len(packet) < 20:
                    continue
                ihl = (packet[0] & 0x0F) * 4
                icmp = packet[ihl:]
            if len(icmp) < 8:
                continue
            ptype, _, _, rident, rseq = struct.unpack("!BBHHH", icmp[:8])
            if ptype != ICMP_ECHO_REPLY:
                continue
            if rseq != seq:
                continue
            # the kernel rewrites the identifier on dgram sockets, so
            # only the raw path can (and must) also check it
            if is_raw and rident != ident:
                continue
            return rtt
    except OSError:
        return None
    finally:
        sock.close()


class Pinger:
    """Rate-limited RTT prober: ICMP first, caller-supplied fallback
    second, cached value when the per-host budget is spent."""

    def __init__(
        self,
        timeout: float = DEFAULT_TIMEOUT,
        min_interval: float = DEFAULT_MIN_INTERVAL,
    ):
        self.timeout = timeout
        self.min_interval = min_interval
        self._lock = threading.Lock()
        self._last: dict[str, tuple[float, float | None]] = {}  # addr -> (t, rtt)
        # learned once: if ICMP is not permitted at all, don't retry a
        # socket() that will fail for every probe of every host
        self._icmp_available: bool | None = None

    def rtt(self, addr: str, fallback=None) -> float | None:
        """RTT to ``addr`` in seconds. ``fallback(addr) -> float | None``
        runs when ICMP is unavailable or failed (the daemon passes its
        TCP connect probe). Rate-limited per host: within
        ``min_interval`` of the last measurement the cached value is
        returned without emitting any traffic."""
        now = time.monotonic()
        with self._lock:
            entry = self._last.get(addr)
            if entry is not None and now - entry[0] < self.min_interval:
                return entry[1]
        rtt = None
        if self._icmp_available is not False:
            rtt = icmp_ping(addr, timeout=self.timeout)
            if rtt is None and self._icmp_available is None:
                # distinguish "no permission ever" from "this host down";
                # the probe socket must be CLOSED, not dropped — this
                # branch can run once per Pinger, but a leaked fd lives
                # for the daemon's whole lifetime
                opened = _open_icmp_socket()
                self._icmp_available = opened is not None
                if opened is not None:
                    opened[0].close()
                else:
                    logger.info("icmp unavailable (no raw/dgram socket); using fallback probes")
            elif rtt is not None:
                self._icmp_available = True
        if rtt is None and fallback is not None:
            rtt = fallback(addr)
        with self._lock:
            self._last[addr] = (time.monotonic(), rtt)
        return rtt
