"""The layer kernel's measurement-only ``phase`` variants and their probe
(``tools/layer_probe.py``) on the CPU: the plain version takes "all" only,
and the probe's ``--cpu`` mode checks its arguments and times nothing."""

import pytest
import torch

from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as lk
from ggml_cuda_experiments_tpu_torch.tools import layer_probe

HEADS = dict(n_heads=32, n_kv_heads=32, head_dim=128)


@pytest.mark.parametrize("phase", [p for p in lk.PHASES if p != "all"])
def test_the_plain_version_refuses_a_measurement_phase(phase):
    h = torch.zeros((1, 4096))
    with pytest.raises(ValueError, match="plain version"):
        lk.layer_step(h, None, None, None, None, 0, **HEADS, phase=phase)
    with pytest.raises(ValueError, match="plain version"):
        lk.model_step(h, None, None, None, None, **HEADS, phase=phase)


def test_an_unknown_phase_is_refused():
    with pytest.raises(ValueError, match="not one of"):
        lk.model_step(torch.zeros((1, 4096)), None, None, None, None,
                      **HEADS, phase="fast")


def test_the_phases_are_the_references_and_no_sync():
    assert list(lk.PHASES) == ["all", "no_bound", "no_attn", "stream",
                               "only_pack", "only_down", "no_sync"]
    assert lk.PHASES["all"] == 0
    assert set(layer_probe.VARIANTS) == set(lk.PHASES) | {"mega2"}


def test_probe_cpu_mode_prints_the_plan(capsys):
    assert layer_probe.main(["--cpu", "--lengths", "57,513",
                             "--model-layers", "32"]) == 0
    out = capsys.readouterr().out
    assert "time not measured" in out
    # one 7B layer: 136.3 MB of q4_k weights; K / V 8.42 MB at 513
    assert "weights 136.3 MB" in out and "K/V 8.42 MB" in out
    assert "bound 43.2 us" in out


@pytest.mark.parametrize("argv", [["--variants", "all,fast"],
                                  ["--lengths", "1024"],
                                  ["--kv-heads", "5"],
                                  ["--calls", "0"],
                                  ["--scan", "--scan-fmt", "q4_0"]])
def test_probe_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        layer_probe.main(["--cpu", *argv])


def test_probe_takes_a_q8_0_scan_alone():
    """``--variants "" --scan --scan-fmt q8_0``: generate_scan on q8_0
    weights and no layer variant (the plan prints none)."""
    args = layer_probe.parse(["--variants", "", "--scan", "--scan-fmt",
                              "q8_0"])
    assert args.variants == [] and args.scan and args.scan_fmt == "q8_0"
    assert layer_probe.parse([]).scan_fmt == "q4_k"
    assert layer_probe.main(["--cpu", "--variants", "", "--scan",
                             "--scan-fmt", "q8_0"]) == 0


def test_probe_byte_bound_counts_the_valid_keys():
    assert layer_probe.kv_bytes(32, 57) == 2 * 32 * 58 * 128 * 2
    assert layer_probe.kv_bytes(8, 1023) == 2 * 8 * 1024 * 128 * 2
    assert layer_probe.kv_bytes(32, 2000) == layer_probe.kv_bytes(32, 1023)
    assert layer_probe.weight_bytes(32) == 136_314_880
