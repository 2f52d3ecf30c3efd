"""utils/compare_steps on the CPU: the pairs' order and the summary, with
the card's measurement replaced by a stand-in (it needs a card)."""

import itertools

from svbrdf_tpu_torch.utils import compare_steps


def test_pairs_alternate_and_summarize(monkeypatch):
    calls, values = [], itertools.count(1)

    def measure(root):
        calls.append(root)
        v = float(next(values))
        return {step: v for step in compare_steps.STEPS}

    monkeypatch.setattr(compare_steps, "measure", measure)
    result = compare_steps.compare("/old", "/new", 4)
    assert calls == ["/old", "/new", "/new", "/old"] * 2
    train = result["summary"]["train_step"]
    # old runs 1, 4, 5, 8; new runs 2, 3, 6, 7
    assert train["old"] == {"median": 4.5, "min": 1.0, "max": 8.0}
    assert train["new"] == {"median": 4.5, "min": 2.0, "max": 7.0}
    assert train["new_faster_pairs"] == 2
    compile(compare_steps._MEASURE, "<measure>", "exec")
