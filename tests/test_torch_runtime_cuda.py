"""The runtime's GPU grant and CUDA tensors on the card.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_runtime_cuda.py
"""

import os
import sys

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the grant and the CUDA "
                    "tensors are the card's")
    ray_tpu_torch.init(num_cpus=2, object_store_memory=512 * 1024 * 1024,
                       log_to_driver=False)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.cuda
def test_granted_task_sees_its_card_and_no_other(runtime):
    rt = runtime
    assert rt.cluster_resources()["GPU"] == torch.cuda.device_count()

    @rt.remote(num_gpus=1)
    def granted():
        import torch

        return [os.environ["CUDA_VISIBLE_DEVICES"],
                torch.cuda.device_count(), torch.cuda.get_device_name(0)]

    visible, count, name = rt.get(granted.remote(), timeout=120)
    assert count == 1 and name == torch.cuda.get_device_name(0)
    assert len(visible.split(",")) == 1


@pytest.mark.cuda
def test_task_without_grant_raises_no_cuda_device(runtime):
    rt = runtime

    @rt.remote
    def ungranted():
        from ray_tpu_torch import resolve_device

        return str(resolve_device(None))

    with pytest.raises(rt.exceptions.RayTaskError, match="no CUDA device"):
        rt.get(ungranted.remote(), timeout=120)


@pytest.mark.cuda
def test_cuda_tensors_cross_bitwise_onto_cuda0(runtime):
    rt = runtime
    x = torch.randn(1024, 513, device="cuda").to(torch.bfloat16)

    @rt.remote(num_gpus=1)
    def roundtrip(t):
        return t.device.type, t * 1

    device_type, back = rt.get(roundtrip.remote(x), timeout=120)
    assert device_type == "cuda" and back.device == torch.device("cuda:0")
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    got = rt.get(rt.put(x), timeout=120)
    assert got.device == torch.device("cuda:0") and torch.equal(got, x)

    @rt.remote
    def ungranted(t):
        return t

    with pytest.raises(rt.exceptions.RayTaskError, match="num_gpus=1"):
        rt.get(ungranted.remote(x), timeout=120)
