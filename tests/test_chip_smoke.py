"""chip_smoke.py rehearsed on the CPU at small sizes, with the culled sweep
forced in Pallas interpret mode; plus the parts of the GPU tooling that the
CPU can check: no-GPU refusal, device description, compile-cache choice."""

import json

import jax
import pytest

import chip_smoke
from raytpu.utils import compile_cache, device


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_gpu():
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main(["--scene", "reference"])
    assert e.value.code not in (0, None)


def test_device_description_on_cpu():
    desc = device.describe()
    assert desc == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    json.dumps(desc)
    assert isinstance(device.card_name_and_power_limit(), str)


def test_compile_cache_env_wins(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.enable() == "/elsewhere"
    assert calls == []


def test_compile_cache_default_is_fixed(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path.endswith(".jax_cache") and path == str(compile_cache.DEFAULT_DIR)
    assert calls == [("jax_compilation_cache_dir", path)]


def test_phase_reference_small():
    chip_smoke.phase_reference(size=(64, 48), frames=2, cli=False)


def test_phase_mesh_small():
    res = chip_smoke.phase_mesh(names=("bunny",), size=(64, 32), interpret=True,
                                frames={"bunny": 2})
    assert set(res["bunny"]) == {"sweep", "dense"}


def test_phase_inverse_small():
    chip_smoke.phase_inverse(size=(64, 32), sweep=True, interpret=True)


def test_phase_multi_small():
    chip_smoke.phase_multi(jax.devices()[:4], size=(64, 32), train_size=(64, 32), sweep=True,
                           interpret=True)
