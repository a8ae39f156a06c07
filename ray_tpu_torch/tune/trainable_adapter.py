"""BaseTrainer.fit → one-trial tune experiment (reference
base_trainer.py:353-354: Trainer.fit constructs a single-trial Tuner).

A copy of ``ray_tpu/tune/trainable_adapter.py``.
"""

from __future__ import annotations

from ray_tpu_torch.air.result import Result


def fit_via_tune(trainer) -> Result:
    """Run a Trainer as a single tune trial.

    The trial actor hosts the trainer's training_loop, which itself
    spawns the train WorkerGroup (nested actors) — matching the
    reference's process topology where the Trainable actor supervises
    RayTrainWorker actors.
    """
    trainable = trainer.as_trainable()

    def trial_fn(config):
        from ray_tpu_torch.air import session

        result: Result = trainable(config)
        # replay the inner history (even on failure — the driver should
        # see the rounds that completed) so the trial's metrics_history
        # matches what the train workers reported round by round
        history = result.metrics_history
        if not history and result.metrics:
            history = [result.metrics]
        if not history and result.error is None:
            history = [{}]
        for i, m in enumerate(history or []):
            session.report(dict(m), checkpoint=result.checkpoint
                           if i == len(history) - 1 else None)
        if result.error is not None:
            raise result.error

    trial_fn.__name__ = getattr(trainable, "__name__", "trainer_trial")

    from ray_tpu_torch.tune.tuner import Tuner

    grid = Tuner(trial_fn, resources_per_trial={"CPU": 0.5}).fit()
    t = grid.trials[0]
    return Result(metrics=t.last_result, checkpoint=t.checkpoint,
                  error=t.error, metrics_history=t.metrics_history)
