"""The launch-and-return check kernel (``kernels/launch_check.py``), the
counterpart of the Pallas ``double`` in ``benchmarks/pallas_tunnel_repro.py``.

That kernel is nested in the repro's ``main``, so the test holds the port's
plain version against the same function, ``x * 2.0``, in jax.numpy on the
same numpy input: exactly equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudf_tpu_torch.kernels import launch_check as port


@pytest.mark.parametrize("n", [0, 1, 1024, 1000])
def test_cpu_tensor_takes_the_plain_version(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    before = port.double.launches
    got = port.double(torch.from_numpy(x))
    assert port.double.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x) * 2.0))


def test_meta_tensor_raises():
    before = port.double.launches
    with pytest.raises(ValueError, match="no kernel"):
        port.double(torch.zeros(1024, device="meta"))
    assert port.double.launches == before


@pytest.mark.parametrize("bad", [torch.zeros(8, dtype=torch.float64), torch.zeros(2, 4),
                                 torch.zeros(16)[::2]])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(TypeError):
        port.double(bad)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    x = torch.randn(1024, device="cuda")
    got = port.double(x)
    torch.cuda.synchronize()
    assert torch.equal(got, port.double_plain(x))
