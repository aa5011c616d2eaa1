"""The port's `paddle.device` package (`paddle_tpu_torch/device/`) on the
CPU: JAX's `__all__` (`paddle_tpu/device/__init__.py`), the place
functions, `synchronize`, and the memory functions' live-tensor
accounting, which follows JAX's live-array accounting
(`paddle_tpu/device/memory.py:58-115`): the bytes of the live tensors'
distinct storages, a high-water mark advanced at each query, and JAX's
dict keys. `program_memory` reads an XLA executable and raises here."""
import numpy as np
import pytest
import torch

import paddle_tpu.device as jdev
import paddle_tpu_torch as tp
import paddle_tpu_torch.device as tdev

from _paddle_state import paddle_state  # noqa: F401


def test_names_are_jax_s_and_the_old_helpers_stay():
    assert set(jdev.__all__) <= set(dir(tdev))
    assert set(jdev.__all__) <= set(tdev.__all__)
    from paddle_tpu_torch.device import on_device, resolve_device

    assert resolve_device("cpu").type == "cpu"
    assert on_device(torch.zeros(1)) is not None
    assert tdev.is_compiled_with_tpu() is False
    assert tdev.get_device() == "cpu:0" and tdev.get_place() == \
        tdev.Place("cpu", 0)
    tdev.synchronize()
    assert tdev.device_count() == torch.cuda.device_count()
    assert tdev.is_compiled_with_cuda() == torch.backends.cuda.is_built()


def test_live_tensor_accounting_on_the_cpu():
    stats = tdev.memory_stats()
    assert set(stats) == {"source", "allocated_bytes",
                          "peak_allocated_bytes", "reserved_bytes",
                          "peak_reserved_bytes", "largest_free_block_bytes",
                          "raw"}
    assert stats["source"] == "live_tensors"
    before = tdev.memory_allocated()
    t = tp.to_tensor(np.ones((512, 1024), np.float32))     # 2 MiB
    view = t[:10]                                           # no new bytes
    after = tdev.memory_allocated("cpu")
    assert after - before == 512 * 1024 * 4
    tdev.reset_peak_memory_stats()
    assert tdev.max_memory_allocated() == after
    del t, view
    assert tdev.memory_allocated() == before
    assert tdev.max_memory_allocated() == after        # the mark stays
    assert tdev.record_peak() == before
    assert tdev.memory_reserved() == before
    assert tdev.max_memory_reserved() == after
    with pytest.raises(NotImplementedError, match="Queue A 14"):
        tdev.memory.program_memory(None)
