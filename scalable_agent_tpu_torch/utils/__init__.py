"""Host utilities: timers, schedules, the logger and small helpers (the
JAX ``scalable_agent_tpu/utils`` package's surface); the algorithm
utilities (``algo``), GIF encoding (``gifs``), text and network helpers
are modules of their own."""

from scalable_agent_tpu_torch.utils.decay import LinearDecay
from scalable_agent_tpu_torch.utils.misc import AttrDict, log
from scalable_agent_tpu_torch.utils.timing import AvgTime, Timing
