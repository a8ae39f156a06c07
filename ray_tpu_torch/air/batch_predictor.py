"""BatchPredictor: checkpoint → parallel batch inference over a Dataset.

Reference analog: python/ray/train/batch_predictor.py (BatchPredictor
.from_checkpoint + .predict over a Dataset with an actor pool).  The
predictor class is constructed ONCE per pool actor from the checkpoint
— model weights load per actor, not per batch — and prediction runs as
a normal dataset stage, so it composes with the rest of the data
pipeline (the reference's GPU batch-prediction benchmark shape,
doc/source/ray-air/benchmarks.rst:119).

A copy of ``ray_tpu/air/batch_predictor.py``.  The reference's stage
captures the checkpoint's dict, so the weights travel inside the
pickled stage chain with every block; here the checkpoint goes into
the object store once (``to_object_ref``) and each pool actor reads it
from there when it builds its predictor (tensors as pickle-5 buffers).
A pool actor holding a card is asked for with
``compute=ActorPoolStrategy(size=..., num_gpus=1)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """User-facing base: subclass with from_checkpoint + predict
    (reference: ray.train.predictor.Predictor)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


class BatchPredictor:
    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor]):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor]
                        ) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls)

    def predict(self, dataset, *, batch_format: str = "numpy",
                compute=None, min_scoring_workers: int = 1,
                max_scoring_workers: Optional[int] = None,
                num_cpus_per_worker: float = 1.0):
        """Run the predictor over every batch of `dataset`; returns a new
        Dataset of predictions.  Uses an actor pool (weights load once
        per actor); size it with min/max_scoring_workers or pass an
        explicit ActorPoolStrategy via `compute`."""
        from ray_tpu_torch.data import ActorPoolStrategy

        ckpt_ref = self._checkpoint.to_object_ref()
        predictor_cls = self._predictor_cls

        class _Scorer:
            def __init__(self):
                self._p = predictor_cls.from_checkpoint(
                    Checkpoint.from_object_ref(ckpt_ref))

            def __call__(self, batch):
                return self._p.predict(batch)

        if compute is None:
            size = max(min_scoring_workers,
                       max_scoring_workers or min_scoring_workers)
            compute = ActorPoolStrategy(size=size,
                                        num_cpus=num_cpus_per_worker)
        return dataset.map_batches(_Scorer, batch_format=batch_format,
                                   compute=compute)
