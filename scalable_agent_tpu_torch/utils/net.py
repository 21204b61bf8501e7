"""Network helpers for multiplayer simulators: the UDP port probe VizDoom
multiplayer games use to pick their host ports.  A copy of
``scalable_agent_tpu/utils/net.py`` (reference: utils/network.py:6-15).
"""

import socket


def is_udp_port_available(port: int) -> bool:
    if not 0 < port < 65536:
        return False
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False


def find_available_udp_port(start_port: int, increment: int = 1000) -> int:
    """First available UDP port in start + k*increment (reference:
    envs/doom/multiplayer/doom_multiagent.py:16-22).  Raises instead of
    returning an out-of-range port."""
    port = start_port
    while port < 65536:
        if is_udp_port_available(port):
            return port
        port += increment
    raise RuntimeError(
        f"no available UDP port in {start_port} + k*{increment} "
        f"below 65536")
