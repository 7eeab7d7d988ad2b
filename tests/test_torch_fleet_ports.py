"""Fleets never share a listen port (service/fleet.py, chip_smoke.Fleet).

The cause of a postmortem drill that failed only under the tier-1
command (`-n 6 --dist loadfile`, many fleets and fronts at once): each
fleet took a port probed free (bind port 0, read it, close it) and its
members bound it seconds later with SO_REUSEPORT. In between, another
test's probe could be handed the same port, and SO_REUSEPORT then let
the two fleets listen on it together without an error, so requests
without an X-LDT-Request-Id reached the drill's members and showed up
among the victim's in-flight ids. Now a fleet started with LISTEN_PORT=0
binds its port itself, holds it for its life and names it on its
`fleet: starting` line; chip_smoke.Fleet starts every fleet so.
"""
from __future__ import annotations

import concurrent.futures
import errno
import socket

import pytest

import chip_smoke


def _listener(port: int) -> socket.socket:
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("0.0.0.0", port))
    s.listen(16)
    return s


def test_a_probed_port_is_shared_without_an_error():
    """What a second fleet handed the same probed port does: its
    members join the first fleet's port, and connections reach both."""
    port = chip_smoke.free_port()
    first, second = _listener(port), _listener(port)
    first.settimeout(0.05)
    second.settimeout(0.05)
    reached = set()
    clients = []
    try:
        for _ in range(64):
            c = socket.create_connection(("127.0.0.1", port), timeout=5)
            clients.append(c)
            for name, srv in (("first", first), ("second", second)):
                try:
                    conn, _ = srv.accept()
                except OSError:
                    continue
                conn.close()
                reached.add(name)
            if len(reached) == 2:
                break
    finally:
        for s in clients + [first, second]:
            s.close()
    assert reached == {"first", "second"}


def _fleet(tmp: str):
    return chip_smoke.Fleet(1, tmp, "tests.fake_worker",
                            FAKE_WORKER_SERVE=tmp)


def test_fleets_started_at_once_hold_distinct_ports(tmp_path):
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        fleets = list(pool.map(_fleet, [str(tmp_path / f"f{i}")
                                        for i in range(4)]))
    try:
        for f in fleets:
            f.wait(lambda s: s["ready"] == 1, "1 READY member")
        ports = [f.port for f in fleets]
        assert len(set(ports)) == len(ports) and all(ports), ports
        assert [f.snap()["listen_port"] for f in fleets] == ports
        # each is held for the fleet's life: a plain bind is refused,
        # and no bind of port 0 is given it
        for port in ports:
            s = socket.socket()
            with pytest.raises(OSError) as e:
                s.bind(("0.0.0.0", port))
            s.close()
            assert e.value.errno == errno.EADDRINUSE
        probes = {chip_smoke.free_port() for _ in range(2000)}
        assert not probes & set(ports)
        assert len({f.sport for f in fleets} | set(ports)) == 2 * len(fleets)
    finally:
        rcs = [f.close() for f in fleets]
    assert rcs == [0] * len(fleets), [f.log()[-1500:] for f in fleets]
