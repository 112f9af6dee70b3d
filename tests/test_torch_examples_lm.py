"""The LM example twins and the layout advisor's on the CPU: the layout
twin prints its reference's plans (`--device cpu`); `torch_serve_batched`
and `torch_train_e2e` run to the end at their smallest preset and print
what their references print."""
import re
import sys

import pytest

from torch_port_util import example_output as printed, load_example as load


@pytest.mark.parametrize("arch,chips", [("tinyllama-1.1b", 256),
                                        ("granite-moe-3b-a800m", 64)])
def test_layout_twin_prints_the_reference_plans(arch, chips, monkeypatch):
    ref = load("layout_advisor")
    monkeypatch.setattr(sys, "argv", ["layout_advisor.py", "--arch", arch,
                                      "--chips", str(chips)])
    want = printed(ref.main)
    got = printed(load("torch_layout_advisor").main,
                  ["--arch", arch, "--chips", str(chips), "--device", "cpu"])
    assert got == want


def test_serve_twin_runs_and_retires_on_eos():
    out = printed(load("torch_serve_batched").main, ["--device", "cpu"])
    assert "served 7 requests" in out
    m = re.search(r"with eos_id=(\d+): req 0 -> \[([\d, ]+)\] \(stopped at "
                  r"EOS, truncated=False\)", out)
    assert m and m.group(2).split(", ")[-1] == m.group(1)


def test_train_twin_runs_and_resumes(tmp_path):
    main = load("torch_train_e2e").main
    args = ["--device", "cpu", "--steps", "2", "--checkpoint-dir",
            str(tmp_path)]
    first = printed(main, args)
    assert re.search(r"model fast-lm: [\d.]+M params", first)
    assert re.search(r"loss [\d.]+ -> [\d.]+ over 2 steps", first)
    again = printed(main, args)           # resumes from step 2
    assert "[trainer] step     2" not in first
    assert re.search(r"loss [\d.]+ -> [\d.]+ over 2 steps", again)
