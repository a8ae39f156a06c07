"""Per-trial result loggers, implemented as tune Callbacks.

Reference analog: ``tune/logger/{csv,json,tensorboardx}.py`` —
``CSVLoggerCallback`` / ``JsonLoggerCallback`` / ``TBXLoggerCallback``
write ``progress.csv`` / ``result.json`` / ``events.out.tfevents.*``
into each trial's logdir so a user can ``tail -f`` progress or point
TensorBoard at the experiment directory mid-run.

The TensorBoard writer emits the public tfevents file format directly
(TFRecord framing with masked crc32c + the tensorflow.Event proto wire
encoding for scalar summaries) rather than requiring tensorboardX —
the format is tiny for scalars and this keeps the dependency surface
at zero.

A copy of ``ray_tpu/tune/logger.py``.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import time
from typing import Any, Dict, IO, Optional

from ray_tpu_torch.tune.callback import Callback

EXPR_RESULT_FILE = "result.json"
EXPR_PROGRESS_FILE = "progress.csv"
EXPR_PARAM_FILE = "params.json"


def _flat(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in (d or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


class LoggerCallback(Callback):
    """Base for per-trial file loggers: manages one open state per trial
    keyed by trial_id, creating ``trial.logdir`` on first use."""

    def _logdir(self, trial) -> str:
        d = getattr(trial, "logdir", None)
        if not d:
            raise RuntimeError(f"trial {trial.trial_id} has no logdir")
        os.makedirs(d, exist_ok=True)
        return d

    def log_trial_start(self, trial) -> None:  # override
        pass

    def log_trial_result(self, trial, result: Dict[str, Any]) -> None:
        pass

    def log_trial_end(self, trial) -> None:
        pass

    # Callback plumbing
    def on_trial_start(self, trial):
        self.log_trial_start(trial)

    def on_trial_result(self, trial, result):
        self.log_trial_result(trial, result)

    def on_trial_complete(self, trial):
        self.log_trial_end(trial)

    def on_experiment_end(self, trials):
        for t in trials:
            self.log_trial_end(t)


class JsonLoggerCallback(LoggerCallback):
    """Appends one JSON object per result to ``result.json`` and writes
    the trial config to ``params.json`` (reference: logger/json.py)."""

    def __init__(self):
        self._files: Dict[str, IO] = {}

    def log_trial_start(self, trial):
        d = self._logdir(trial)
        with open(os.path.join(d, EXPR_PARAM_FILE), "w") as f:
            json.dump(trial.config, f, default=repr)
        if trial.trial_id not in self._files:
            self._files[trial.trial_id] = open(
                os.path.join(d, EXPR_RESULT_FILE), "a")

    def log_trial_result(self, trial, result):
        f = self._files.get(trial.trial_id)
        if f is None:
            self.log_trial_start(trial)
            f = self._files[trial.trial_id]
        json.dump(result, f, default=repr)
        f.write("\n")
        f.flush()

    def log_trial_end(self, trial):
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()


class CSVLoggerCallback(LoggerCallback):
    """Appends results to ``progress.csv`` (reference: logger/csv.py:69
    CSVLoggerCallback).  The header is fixed by the first result; later
    keys not in the header are dropped, missing keys write empty cells —
    same contract as the reference."""

    def __init__(self):
        self._writers: Dict[str, csv.DictWriter] = {}
        self._files: Dict[str, IO] = {}

    def log_trial_result(self, trial, result):
        flat = _flat(result)
        tid = trial.trial_id
        if tid not in self._writers:
            path = os.path.join(self._logdir(trial), EXPR_PROGRESS_FILE)
            f = open(path, "a")
            w = csv.DictWriter(f, fieldnames=sorted(flat.keys()),
                               extrasaction="ignore")
            if f.tell() == 0:
                w.writeheader()
            self._files[tid], self._writers[tid] = f, w
        self._writers[tid].writerow(flat)
        self._files[tid].flush()

    def log_trial_end(self, trial):
        f = self._files.pop(trial.trial_id, None)
        self._writers.pop(trial.trial_id, None)
        if f is not None:
            f.close()


# ---------------------------------------------------------------------------
# TensorBoard event files without tensorboardX.
#
# File format (public): a sequence of TFRecords, each
#   uint64le  length
#   uint32le  masked_crc32c(length_bytes)
#   bytes     data
#   uint32le  masked_crc32c(data)
# where data is a serialized tensorflow.Event protobuf.  For scalars only
# three Event fields matter: wall_time(1,double), step(2,int64),
# summary(5) { repeated value(1) { tag(1,string),
# simple_value(2,float) } }; plus file_version(3,string) in the first
# record.  (Same bytes tensorboardX's RecordWriter produces.)
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:  # proto varints are unsigned; negatives would loop forever
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    val = (_len_delim(1, tag.encode()) +
           _field(2, 5) + struct.pack("<f", float(value)))
    summary = _len_delim(1, val)
    return (_field(1, 1) + struct.pack("<d", wall_time) +
            _field(2, 0) + _varint(step) +
            _len_delim(5, summary))


def _version_event(wall_time: float) -> bytes:
    return (_field(1, 1) + struct.pack("<d", wall_time) +
            _len_delim(3, b"brain.Event:2"))


class _EventFileWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.raytpu"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._record(_version_event(time.time()))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(tag, value, step, time.time()))

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # noqa: BLE001
            pass


class TBXLoggerCallback(LoggerCallback):
    """Writes scalar results as TensorBoard event files into each trial
    logdir (reference: logger/tensorboardx.py TBXLoggerCallback)."""

    #: result keys that are bookkeeping, not learning curves
    EXCLUDE = {"done", "trial_id", "timestamp"}

    def __init__(self):
        self._writers: Dict[str, _EventFileWriter] = {}

    def log_trial_result(self, trial, result):
        w = self._writers.get(trial.trial_id)
        if w is None:
            w = self._writers[trial.trial_id] = _EventFileWriter(
                self._logdir(trial))
        step = max(0, int(result.get("training_iteration",
                                     trial.iteration) or 0))
        for k, v in _flat(result).items():
            if k in self.EXCLUDE:
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            w.add_scalar(f"ray/tune/{k}", float(v), step)

    def log_trial_end(self, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()


def read_tfevents(path: str):
    """Parse scalar events back out of a tfevents file (test/debug aid).

    Yields (tag, value, step) tuples; skips the version record."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (n,) = struct.unpack("<Q", header)
            f.read(4)
            data = f.read(n)
            f.read(4)
            # minimal proto walk: find step (field 2 varint) and
            # summary (field 5)
            step, i = 0, 0
            tag, value = None, None
            while i < len(data):
                key = data[i]
                i += 1
                fnum, wire = key >> 3, key & 7
                if wire == 0:
                    v = 0
                    shift = 0
                    while True:
                        b = data[i]
                        i += 1
                        v |= (b & 0x7F) << shift
                        shift += 7
                        if not b & 0x80:
                            break
                    if fnum == 2:
                        step = v
                elif wire == 1:
                    i += 8
                elif wire == 5:
                    i += 4
                elif wire == 2:
                    ln = 0
                    shift = 0
                    while True:
                        b = data[i]
                        i += 1
                        ln |= (b & 0x7F) << shift
                        shift += 7
                        if not b & 0x80:
                            break
                    payload = data[i:i + ln]
                    i += ln
                    if fnum == 5:  # summary -> value -> tag/simple_value
                        j = 0
                        while j < len(payload):
                            k2 = payload[j]
                            j += 1
                            if k2 >> 3 == 1 and k2 & 7 == 2:
                                ln2 = payload[j]
                                j += 1
                                inner = payload[j:j + ln2]
                                j += ln2
                                m = 0
                                while m < len(inner):
                                    k3 = inner[m]
                                    m += 1
                                    if k3 >> 3 == 1 and k3 & 7 == 2:
                                        ln3 = inner[m]
                                        m += 1
                                        tag = inner[m:m + ln3].decode()
                                        m += ln3
                                    elif k3 >> 3 == 2 and k3 & 7 == 5:
                                        (value,) = struct.unpack(
                                            "<f", inner[m:m + 4])
                                        m += 4
                                    else:
                                        m = len(inner)
                            else:
                                j = len(payload)
            if tag is not None:
                yield (tag, value, step)


DEFAULT_LOGGERS = (JsonLoggerCallback, CSVLoggerCallback,
                   TBXLoggerCallback)
