"""Host helpers for multi-process runs (counterpart of
``windtpu/utils/hostcpu.py``).  ``free_tcp_port`` is a copy of the JAX
package's, pinned to it by ``tests/test_torch_copies.py``; the virtual-CPU
recipe there is JAX's own and has no counterpart: a torch process sees its
devices as they are, and a CPU rank is a process."""

import socket


def free_tcp_port() -> int:
    """An OS-assigned free TCP port (for a ``torch.distributed``
    rendezvous).

    Racy in principle (released before the child binds) but eliminates
    collisions with fixed/pid-derived ports in concurrent test runs.
    """
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
