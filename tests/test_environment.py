"""Process set-up: where the compile cache goes, and what each launched
process of a group is given."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_PROBE = "import deplex_tpu, jax; print(jax.config.jax_compilation_cache_dir)"


def _cache_dir(env_update):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_env_var_wins(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    assert _cache_dir({}) == str(ROOT / ".jax_cache")


@pytest.mark.parametrize("platform", ["gpu", "cuda"])
def test_launcher_gives_each_process_one_card(platform):
    from deplex_tpu.parallel.launcher import process_env

    envs = [process_env(pid, 4, 4321, platform=platform, base_env={})
            for pid in range(4)]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
    assert {e["JAX_PLATFORMS"] for e in envs} == {"cuda"}
    assert [e["JAX_PROCESS_ID"] for e in envs] == ["0", "1", "2", "3"]
    assert {e["JAX_COORDINATOR_ADDRESS"] for e in envs} == {"127.0.0.1:4321"}


def test_launcher_cpu_simulation_env():
    from deplex_tpu.parallel.launcher import process_env

    env = process_env(1, 2, 99, platform="cpu", local_devices=4,
                      base_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8 --a"})
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert env["JAX_PLATFORMS"] == "cpu" and env["JAX_NUM_PROCESSES"] == "2"
    assert env["XLA_FLAGS"] == "--a --xla_force_host_platform_device_count=4"
