"""The global state both paddle packages keep, restored after each test of
the files that use `paddle_state`: the amp state, the `FLAGS_*`, the
`OpStats` switches, counts and span hook, the random generators, and the
port's selected place (the CPU for the test). The driver runs several
files in one worker, so a test leaves nothing behind."""
import sys

import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.ops.dispatch import OpStats as JStats
from paddle_tpu_torch.ops.dispatch import OpStats as TStats

FLAGS = ("FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level",
         "FLAGS_cudnn_deterministic", "FLAGS_embedding_deterministic")
AMP = (sys.modules["paddle_tpu.amp.auto_cast"],
       sys.modules["paddle_tpu_torch.amp.auto_cast"])


@pytest.fixture(autouse=True)
def paddle_state():
    amp = [dict(m._state) for m in AMP]
    flags = [pkg.get_flags(list(FLAGS)) for pkg in (jp, tp)]
    stats = [(S.enabled, dict(S.counts), S.span_hook, S.sync_spans)
             for S in (JStats, TStats)]
    rng = jp.get_rng_state(), tp.get_rng_state()
    tp.set_device("cpu")
    yield
    for m, st in zip(AMP, amp):
        m._state.clear()
        m._state.update(st)
    for pkg, f in zip((jp, tp), flags):
        pkg.set_flags(f)
    for S, (en, counts, hook, sync) in zip((JStats, TStats), stats):
        S.enabled, S.counts, S.span_hook, S.sync_spans = en, counts, hook, \
            sync
    jp.set_rng_state(rng[0])
    tp.set_rng_state(rng[1])
    jp.set_default_dtype("float32")
    tp.set_default_dtype("float32")
