"""Small shared utilities: the counterpart of
``scalable_agent_tpu/utils/misc.py`` (reference: utils/utils.py, the
logger :13-37, ``AttrDict`` :42-49, the memory probe :139-142).

``log`` is the package's logger, ``scalable_agent_tpu_torch``, which every
module of the port logs to.  Unlike the JAX module, importing this one
attaches no handler: the port's entry points configure logging
(``logging.basicConfig`` in the CLIs), and a library import changes no
process-wide state.
"""

import logging

log = logging.getLogger("scalable_agent_tpu_torch")


class AttrDict(dict):
    """dict with attribute access (reference: utils/utils.py:42-49)."""

    __setattr__ = dict.__setitem__

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc


def memory_consumption_mb() -> float:
    """Resident set size of this process in MB; 0.0 without ``psutil``
    (reference: utils/utils.py:139-142)."""
    try:
        import psutil
    except ImportError:
        return 0.0
    return psutil.Process().memory_info().rss / (1024 * 1024)
