"""Public exception types (reference analog: python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class RayTaskError(RayTpuError):
    """A task raised; re-raised at every ``get()`` of its return objects.

    Carries the remote traceback string (reference analog:
    python/ray/exceptions.py RayTaskError, which wraps the cause and
    prepends the remote stack).
    """

    def __init__(self, cause_repr: str, remote_traceback: str,
                 cause: BaseException | None = None):
        self.cause_repr = cause_repr
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(self._format())

    def _format(self) -> str:
        msg = f"task raised {self.cause_repr}"
        if self.remote_traceback:
            msg += "\n\nRemote traceback:\n" + self.remote_traceback
        return msg

    def __reduce__(self):
        return (type(self), (self.cause_repr, self.remote_traceback, self.cause))


class RayActorError(RayTpuError):
    """The actor died (crashed, was killed, or its node died) before or
    during the method call."""


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """Actor is temporarily unreachable (e.g. restarting)."""


class TaskCancelledError(RayTpuError):
    pass


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died mid-execution."""


class ObjectLostError(RayTpuError):
    """Object's value was lost (evicted / owner died) and could not be
    reconstructed from lineage."""


class OwnerDiedError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass
