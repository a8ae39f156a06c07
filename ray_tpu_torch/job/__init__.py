"""Job submission: run driver scripts on the cluster with status + logs.

A copy of ``ray_tpu/job/``.  Role-equivalent of the reference's job
submission stack (reference
``dashboard/modules/job/job_manager.py:376 JobManager``, ``:128
JobSupervisor``, ``:520 submit_job``; REST/SDK/CLI under
``dashboard/modules/job/``).
"""

from ray_tpu_torch.job.manager import (JobInfo, JobStatus, get_job_info,
                                 get_job_logs, get_job_status, list_jobs,
                                 stop_job, submit_job, wait_job)

__all__ = [
    "JobStatus", "JobInfo", "submit_job", "get_job_status", "get_job_info",
    "get_job_logs", "list_jobs", "stop_job", "wait_job",
]
