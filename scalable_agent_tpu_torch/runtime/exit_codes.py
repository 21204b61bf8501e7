"""Every deliberate non-zero exit of the runtime, in one table.

A copy of ``scalable_agent_tpu/runtime/exit_codes.py``: a supervisor
restarts failed runs by exit code, so both packages give a failure the
same number.

| Code | Name | Raised by (in this package) | Meaning |
|---|---|---|---|
| 70 | watchdog | obs/watchdog.py (``--watchdog_abort``) | a pipeline thread missed its heartbeat deadline |
| 71 | non-finite | driver._rollback_or_exit | the non-finite tolerance was exhausted with ``--no_rollback`` or nothing restorable |
| 72 | fleet | runtime/fleet.py | the preemption grace window expired before the drain finished |
| 73 | sentinel | runtime/sentinel.py | silent numeric corruption survived the degradation ladder and a rollback |

``128 + signum`` (143 for a SIGTERM with ``--preemption_grace_s=0``, or
for a second SIGTERM, after the flight recorder's dump) keeps its POSIX
meaning; 0 is a completed run,
including a preempted run that drained and checkpointed inside its grace
window.

Pure constants, no imports.
"""

WATCHDOG_EXIT_CODE = 70
NONFINITE_EXIT_CODE = 71
FLEET_EXIT_CODE = 72
SENTINEL_EXIT_CODE = 73

# name -> (code, one-line operator meaning), as in the JAX package.
EXIT_CODES = {
    "watchdog": (WATCHDOG_EXIT_CODE,
                 "a pipeline thread missed its heartbeat deadline "
                 "(hang; --watchdog_abort)"),
    "nonfinite": (NONFINITE_EXIT_CODE,
                  "non-finite tolerance exhausted with --no_rollback "
                  "or no restorable checkpoint"),
    "fleet": (FLEET_EXIT_CODE,
              "peer lost / collective timed out / preemption grace "
              "expired — restart resumes from the last checkpoint"),
    "sentinel": (SENTINEL_EXIT_CODE,
                 "silent numeric corruption survived the full "
                 "degradation ladder and a rollback — restart at the "
                 "same shape (the reference path is trusted; persistent "
                 "breach points at the hardware)"),
}
