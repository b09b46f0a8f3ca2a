"""searchplot app: SIGPROC input Source + dedispersed plots
(reference More/Applications/searchplot.C)."""

import os

import numpy as np
import pytest

from dspsr_jax.io import open_source
from dspsr_jax.io.sigproc import SigProcFile, SigProcWriter
from dspsr_jax.observation import Observation, Signal
from dspsr_jax.timing.mjd import MJD
from dspsr_jax.apps.searchplot_app import main, dedisperse_shifts


@pytest.fixture
def dispersed_fil(tmp_path):
    """8-bit filterbank with one dispersed pulse riding on noise."""
    nchan, nsamp, dm = 64, 4096, 30.0
    rate = 10e3  # 0.1 ms samples
    obs = Observation(
        nchan=nchan, npol=1, ndim=1, nbit=8,
        centre_frequency=1400.0, bandwidth=-64.0, rate=rate,
        start_time=MJD.from_mjd(55000.0), state=Signal.INTENSITY,
        source="FAKE_PSR",
    )
    rng = np.random.default_rng(7)
    data = rng.normal(40.0, 4.0, (nsamp, nchan))
    path = str(tmp_path / "pulse.fil")
    w = SigProcWriter(path, obs, 8)
    shifts = dedisperse_shifts(obs, dm)
    t_pulse = 1000
    for c in range(nchan):
        data[t_pulse + shifts[c], c] += 80.0
    w.write_block(np.clip(data, 0, 255).astype(np.uint8).ravel())
    w.close()
    return path, obs, dm, t_pulse, rate


def test_sigproc_source_registered(dispersed_fil):
    path, obs, *_ = dispersed_fil
    src = open_source(path)
    assert isinstance(src, SigProcFile)
    assert src.obs.nchan == obs.nchan
    assert src.total_samples == 4096
    d = src.read_detected(0, 16)
    assert d.shape == (16, 1, 64)
    # past-EOD reads zero-pad
    tail = src.read_samples(4090, 16)
    assert tail[6 * 64:].max() == 0


def test_dedispersed_sum_recovers_pulse(dispersed_fil, tmp_path):
    path, obs, dm, t_pulse, rate = dispersed_fil
    os.chdir(tmp_path)
    assert main([path, "-K", "-D", str(dm), "-s",
                 "-g", str(tmp_path / "k.png")]) == 0
    assert (tmp_path / "k.png").exists()
    t, summed = np.loadtxt("searchplot.out").T
    peak = int(np.argmax(summed))
    assert abs(peak - t_pulse) <= 1  # pulse realigned by dedispersion
    assert t[peak] == pytest.approx(t_pulse / rate, abs=2 / rate)


def test_waterfall_and_histogram_pngs(dispersed_fil, tmp_path):
    path, *_ = dispersed_fil
    out = str(tmp_path / "fh.png")
    assert main([path, "-F", "-H", "-g", out]) == 0
    assert os.path.getsize(out) > 2000


def test_last_seconds_window(dispersed_fil, tmp_path):
    path, obs, dm, t_pulse, rate = dispersed_fil
    out = str(tmp_path / "last.png")
    assert main([path, "-F", "-l", "0.1", "-g", out]) == 0
    assert os.path.exists(out)
