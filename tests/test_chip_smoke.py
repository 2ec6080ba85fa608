"""chip_smoke.py's phases at tiny size on the CPU, called directly, and
its refusal to run without a GPU.  The full-width run is the script itself
on the card (`python chip_smoke.py`)."""

import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def tx():
    return cs.phase_tx(channels=3, n_frames=3, card="cpu")


@pytest.fixture(scope="module")
def steady(tx):
    return cs.phase_steady(tx, card="cpu", reps=1, soft_channels=2)


class TestRefusal:
    def test_main_refuses_without_gpu(self, monkeypatch, tmp_path, capsys):
        monkeypatch.setenv("PATH", str(tmp_path))     # no nvidia-smi
        assert cs.main([]) != 0
        assert cs.main(["--four"]) != 0
        assert capsys.readouterr().out == ""          # no result line

    def test_alone_without_the_program(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == ""


class TestPhasesOnCpu:
    def test_tx_bank(self, tx):
        assert tx["x"].shape[0] == 3 and tx["frames"].shape == (3, 3, 134)

    def test_steady_decodes_every_payload(self, steady):
        assert steady["soft_err_highest"] <= 1e-5
        assert set(steady) >= {"f32", "int8", "soft_f32", "soft_int8"}

    def test_viterbi_kernel_vs_scan(self, tx, steady):
        res = cs.phase_viterbi(tx, steady["acq"], card="cpu", reps=1,
                               kernel="pallas_interpret", small_frames=1)
        assert {"steady_9", "steady_3", "alone_9", "alone_3"} <= set(res)

    def test_stream(self):
        cs.phase_stream(channels=2, blocks=2, block_frames=1, card="cpu")

    def test_wideband(self):
        cs.phase_wideband(k=4, n_active=3, n_frames=3, card="cpu")

    def test_check_raises(self):
        with pytest.raises(cs.SmokeFailure, match="boom"):
            cs.check(False, "boom")


class TestChildPhasesOnCpu:
    def test_cli_raw_round_trip(self):
        cs.phase_cli_raw(1, 3, device="cpu")

    def test_cli_raw_multichannel(self):
        cs.phase_cli_raw(3, 3, device="cpu")

    def test_exact_tx_identical(self):
        cs.phase_exact_tx("cpu")

    def test_modem_loopback(self):
        cs.phase_modem("cpu", n_frames=3, card="cpu")
