"""One best-effort delivery of a serialized metric set (counterpart of
``loghisto_tpu/submitter.py``: ``send_once`` and ``DIAL_TIMEOUT_S``; the
backlog ``Submitter`` and ``BacklogSender`` come with slice 6b).

Reference semantics (submitter.go:33-159): each send is a fresh dial
with a 5 s connect/write timeout; delivery is best-effort, at-most-once
and unacknowledged.
"""

from __future__ import annotations

import socket
from typing import Optional

DIAL_TIMEOUT_S = 5.0


def send_once(
    network: str,
    address: tuple[str, int],
    payload: bytes,
    timeout: float = DIAL_TIMEOUT_S,
) -> Optional[Exception]:
    """One best-effort delivery: fresh dial, write, close.  Returns the
    error, if any (never raises for network failures)."""
    try:
        if network == "tcp":
            # create_connection resolves both IPv4 and IPv6.
            with socket.create_connection(address, timeout=timeout) as sock:
                sock.sendall(payload)
        else:
            host, port = address
            family, sock_type, proto, _, addr = socket.getaddrinfo(
                host, port, type=socket.SOCK_DGRAM
            )[0]
            sock = socket.socket(family, sock_type, proto)
            sock.settimeout(timeout)
            try:
                sock.sendto(payload, addr)
            finally:
                sock.close()
        return None
    except OSError as e:
        return e
