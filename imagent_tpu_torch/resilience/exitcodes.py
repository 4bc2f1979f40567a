"""Process exit-code taxonomy: one registry for every deliberate exit.

The subset of ``imagent_tpu/resilience/exitcodes.py`` this port uses,
copied with the same numbers and meanings (a launcher's requeue wrapper
decides from the code alone whether a restart can help). The numeric
choices borrow sysexits.h (78 ``EX_CONFIG``). The pod codes (75, 86-90)
join when the port gains the subsystems that raise them.

``FatalRunError`` and its subclasses carry a code out of ``engine.run``;
``__main__`` maps it to the process exit code.
"""

from __future__ import annotations

import dataclasses

OK = 0
FATAL_EXCEPTION = 70    # EX_SOFTWARE: unhandled exception, unclassified
FATAL_CONFIG = 78       # EX_CONFIG: invalid flags/topology — reproduces
ROLLBACK_GIVE_UP = 79   # non-finite steps persisted through the rollback
                        # budget — the fault replays deterministically


@dataclasses.dataclass(frozen=True)
class ExitCode:
    code: int
    name: str
    retryable: bool
    doc: str


REGISTRY: tuple[ExitCode, ...] = (
    ExitCode(OK, "ok", False, "clean finish — nothing to requeue"),
    ExitCode(FATAL_EXCEPTION, "exception", False,
             "unhandled exception; diagnose before rerunning"),
    ExitCode(FATAL_CONFIG, "fatal-config", False,
             "invalid or not-yet-ported flags, or no CUDA device for "
             "--backend gpu"),
    ExitCode(ROLLBACK_GIVE_UP, "rollback-give-up", False,
             "non-finite steps survived every rollback replay "
             "(data/lr/bf16 problem, not a transient)"),
)

_BY_CODE = {e.code: e for e in REGISTRY}


def describe(code: int) -> ExitCode | None:
    """The registry entry for ``code``, or None for unregistered codes."""
    return _BY_CODE.get(int(code))


class FatalRunError(RuntimeError):
    """A run-ending failure that carries its exit classification."""

    exit_code: int = FATAL_EXCEPTION
    reason: str = "exception"


class RollbackGiveUpError(FatalRunError):
    """The non-finite-step fault reproduced through every rollback
    replay — a config/data problem a requeue would only repeat."""

    exit_code = ROLLBACK_GIVE_UP
    reason = "rollback-give-up"
