"""Unique identifiers for jobs, tasks, actors, objects, nodes, and workers.

Design notes
------------
The reference framework derives object IDs from the task that produced them
(lineage-encoded bit layout, see reference ``src/ray/common/id.h`` /
``id_def.h``).  We keep that property — an ObjectID embeds its producing
TaskID plus a return/put index — because lineage reconstruction and ownership
need to map an object back to the task that can recreate it, but the layout
here is our own:

    JobID    =  4 bytes  (counter assigned by the GCS)
    ActorID  = 12 bytes  = JobID(4) + unique(8)
    TaskID   = 20 bytes  = ActorID(12) + unique(8)
    ObjectID = 24 bytes  = TaskID(20) + index(4)   # index: 1-based return slot,
                                                   # or a put-counter for ray.put
    NodeID / WorkerID / PlacementGroupID = 16 random bytes

All IDs are immutable, hashable, and render as fixed-width hex.
"""

from __future__ import annotations

import os
import threading

_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 12
_TASK_ID_SIZE = 20
_OBJECT_ID_SIZE = 24
_UNIQUE_ID_SIZE = 16


class BaseID:
    """Immutable byte-string identifier."""

    SIZE = _UNIQUE_ID_SIZE
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {id_bytes!r}"
            )
        object.__setattr__(self, "_bytes", id_bytes)
        object.__setattr__(self, "_hash", hash((type(self).__name__, id_bytes)))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __setattr__(self, *a):  # immutable
        raise AttributeError(f"{type(self).__name__} is immutable")

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "big"))

    def to_int(self) -> int:
        return int.from_bytes(self._bytes, "big")


class NodeID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class WorkerID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(_ACTOR_ID_SIZE - _JOB_ID_SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        """A normal (non-actor) task: actor part is the nil actor of this job."""
        actor = ActorID(job_id.binary() + b"\x00" * (_ACTOR_ID_SIZE - _JOB_ID_SIZE))
        return cls(actor.binary() + os.urandom(_TASK_ID_SIZE - _ACTOR_ID_SIZE))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + os.urandom(_TASK_ID_SIZE - _ACTOR_ID_SIZE))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        """The implicit root task of a driver process."""
        actor = ActorID(job_id.binary() + b"\x00" * (_ACTOR_ID_SIZE - _JOB_ID_SIZE))
        return cls(actor.binary() + b"\xff" * (_TASK_ID_SIZE - _ACTOR_ID_SIZE))

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:_ACTOR_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        """index is the 1-based return-value slot of the producing task."""
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_ID_SIZE:], "big")


class _PutCounter:
    """Per-process counter for ray.put object ids (distinct slot space: the
    high bit of the 4-byte index marks puts, so returns and puts never
    collide)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def next(self) -> int:
        with self._lock:
            self._n += 1
            return self._n | 0x80000000


_put_counter = _PutCounter()


def put_object_id(current_task_id: TaskID) -> ObjectID:
    return ObjectID.for_return(current_task_id, _put_counter.next())
