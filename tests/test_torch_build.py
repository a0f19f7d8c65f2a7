"""volq_torch._build.launch, the port's one kernel boundary, on the CPU:
a fake C function stands in for a kernel library's, so no ``nvcc`` runs.
Each case checks that the function is bound once, with its argument
types, that every call passes its arguments through, that a non-zero
return raises naming the function and its code (worded by the probe's
own table where one is passed), and that each successful call counts 1
in ``_build.launches`` and, under a profiler, under the innermost open
``volq.*`` span."""
import contextlib
from collections import Counter

import pytest
from torch.profiler import ProfilerActivity, profile

from volq_torch import _build
from volq_torch.core import trace
from volq_torch.probe import tensor_core, window

ARGTYPES = ["fake argtypes"]


@pytest.mark.parametrize("codes, spans, why, match", [
    ((0, 0, 0), None, None, None),
    ((0, 0), ("volq.frame", "volq.render", "volq.render.march"), None, None),
    ((0,), (), None, None),
    ((0, 7, 0), None, None, "fake_launch failed: CUDA error 7$"),
    ((-1,), None, window._why, "fake_launch failed: tensor map refused "
     r"\(-1\)$"),
    ((0, -1), None, tensor_core._why, "fake_launch failed: the driver "
     "gives no cuTensorMapEncodeTiled$"),
    ((-1003,), None, tensor_core._why, "fake_launch failed: tensor map "
     r"refused \(CUresult 3\)$"),
], ids=["counts", "traced", "traced-outside-spans", "cuda-error",
        "window-table", "mma-no-encoder", "mma-map-refused"])
def test_launch_binds_once_checks_and_counts(monkeypatch, codes, spans, why,
                                             match):
    binds, calls = [], []

    def fake(*args):
        calls.append(args)
        return codes[len(calls) - 1]

    def bind(lib, name, argtypes):
        binds.append((lib, name, argtypes))
        return fake

    monkeypatch.setattr(_build, "_bind", bind)
    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(_build, "launches", Counter())
    trace.reset()
    ok = 0
    with profile(activities=[ProfilerActivity.CPU]) \
            if spans is not None else contextlib.nullcontext():
        with contextlib.ExitStack() as stack:
            for s in spans or ():
                stack.enter_context(trace.span(s))
            for i, code in enumerate(codes):
                if code:
                    with pytest.raises(RuntimeError, match=match):
                        _build.launch("fake", "fake_launch", ARGTYPES, i,
                                      "x", why=why)
                else:
                    _build.launch("fake", "fake_launch", ARGTYPES, i, "x",
                                  why=why)
                    ok += 1
                assert _build.launches == Counter({"fake_launch": ok})
    counted = trace.counters()
    trace.reset()
    assert binds == [("fake", "fake_launch", ARGTYPES)]
    assert calls == [(i, "x") for i in range(len(codes))]
    if spans is None:
        assert counted == {}
    else:
        assert counted == {(spans[-1] if spans else None, "fake_launch"): ok}
