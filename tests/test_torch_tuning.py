"""The port's per-device table and streaming-ceiling probe
(gpusolve_tpu_torch/utils/tuning.py) on the CPU."""

import json

import pytest

from gpusolve_tpu_torch.utils import tuning


@pytest.mark.parametrize("name,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0),
    ("NVIDIA H200", 4800.0),
])
def test_hopper_rows(name, gbps):
    assert tuning.known_kind(name)
    t = tuning.for_kind(name)
    assert t.peak_hbm_gbps == gbps
    assert t.cpu_strip_kb == 32


def test_unknown_kind_gets_the_default():
    for kind in ("NVIDIA A100-SXM4-80GB", "", None):
        assert not tuning.known_kind(kind)
        assert tuning.for_kind(kind) == tuning.DeviceTuning()


def test_no_device_on_the_cpu():
    assert tuning.device_kind() == ""
    assert tuning.current() == tuning.DeviceTuning()
    assert tuning.probe_ceiling_gbps() is None
    assert tuning.probe_ceiling_gbps(refresh=True) is None


def test_probe_cache_under_xdg_cache_home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    path = tmp_path / "gpusolve_tpu_torch" / "probe.json"
    assert tuning._cache_path() == str(path)
    name = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(tuning, "device_kind", lambda: name)
    measured = iter([3001.5, 2999.0])
    monkeypatch.setattr(tuning, "_measure_copy_gbps",
                        lambda: next(measured))
    assert tuning.probe_ceiling_gbps() == 3001.5  # measured, then cached
    assert json.loads(path.read_text()) == {name: 3001.5}
    assert tuning.probe_ceiling_gbps() == 3001.5  # from the cache
    assert tuning.probe_ceiling_gbps(refresh=True) == 2999.0
    assert json.loads(path.read_text()) == {name: 2999.0}
    path.write_text("not json")
    monkeypatch.setattr(tuning, "_measure_copy_gbps", lambda: 3010.0)
    assert tuning.probe_ceiling_gbps() == 3010.0
