"""Platform selection, the compile cache, the GPU-only entry points' refusal
to run without a GPU, and the tests that need the card (marked `gpu`)."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _py(code, env=None, timeout=120):
    e = dict(os.environ, PYTHONPATH=str(ROOT))
    e.update(env or {})
    for k, v in list(e.items()):
        if v is None:
            del e[k]
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=e,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU is visible (decided here, at run time)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU; python chip_smoke.py covers this "
                    "on the card")


class TestCompileCache:
    CODE = ("from opv_tpu.cli._platform import enable_compile_cache; "
            "import jax; print(enable_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")

    def test_honours_env_var(self, tmp_path):
        r = _py(self.CODE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert r.returncode == 0, r.stderr
        assert r.stdout.split() == [str(tmp_path), str(tmp_path)]

    def test_fixed_in_checkout_path_otherwise(self):
        r = _py(self.CODE, {"JAX_COMPILATION_CACHE_DIR": None})
        assert r.returncode == 0, r.stderr
        want = str(ROOT / ".jax_cache")
        assert r.stdout.split() == [want, want]

    def test_cache_dir_is_ignored_by_git(self):
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


class TestDeviceSelection:
    def test_gpu_maps_to_cuda(self):
        from opv_tpu.cli import _platform
        assert _platform._PLATFORMS["gpu"] == "cuda"

    def test_setup_platform_gpu_fails_without_gpu(self, gpu_absent):
        r = _py("from opv_tpu.cli._platform import setup_platform; "
                "setup_platform('gpu')", {"JAX_PLATFORMS": None})
        assert r.returncode != 0
        assert "no gpu device available" in r.stderr

    def test_cli_device_gpu_fails_without_gpu(self, gpu_absent):
        r = subprocess.run(
            [sys.executable, "-m", "opv_tpu.cli.opv_mod", "-S", "W5NYV",
             "-B", "1", "--device", "gpu"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)),
            capture_output=True, timeout=120)
        assert r.returncode != 0 and r.stdout == b""

    def test_bench_exits_nonzero_without_gpu(self, gpu_absent):
        r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=str(ROOT)),
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == ""
        assert "--cpu" in r.stderr

    def test_auto_resolves_to_kernel_on_gpu(self, monkeypatch):
        from opv_tpu.ops import registry
        monkeypatch.setattr(registry, "_backend", "auto")
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert registry.get_backend() == "pallas"
        monkeypatch.setattr(registry, "_backend", "pallas")
        assert registry.get_backend() == "pallas"


class TestDefaults:
    def test_stream_dtype_auto_is_float32(self):
        from opv_tpu.stream import LockedStreamDemodulator
        sd = LockedStreamDemodulator(channels=1, block_frames=1)
        assert sd.dtype == np.float32

    def test_peaks_table(self):
        from opv_tpu.utils.peaks import device_peaks
        h100 = device_peaks("NVIDIA H100 80GB HBM3")
        assert h100["hbm_bytes_per_s"] == 3.35e12
        with pytest.raises(KeyError, match="no published peaks"):
            device_peaks("cpu")


@pytest.fixture
def gpu_absent():
    if shutil.which("nvidia-smi") is not None:
        pytest.skip("a GPU is present")


@pytest.mark.gpu
class TestOnGpu:
    def test_viterbi_kernel_bit_exact_on_gpu(self, gpu):
        r = _py("import numpy as np, jax; "
                "from opv_tpu.cli._platform import setup_platform; "
                "setup_platform('gpu', x64=False); "
                "from opv_tpu.ops.pallas.viterbi import viterbi_pallas; "
                "from opv_tpu.rx.viterbi import viterbi_decode_batch; "
                "s = jax.numpy.asarray(np.random.default_rng(0)"
                ".integers(0, 8, (1280, 2144)).astype(np.int32)); "
                "a = viterbi_pallas(s); b = viterbi_decode_batch(s); "
                "assert (np.asarray(a[0]) == np.asarray(b[0])).all(); "
                "assert (np.asarray(a[1]) == np.asarray(b[1])).all()",
                {"JAX_PLATFORMS": None}, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
