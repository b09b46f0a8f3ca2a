"""Tests for Observation metadata and DADA header parsing."""

from dspsr_jax.observation import Observation, Signal
from dspsr_jax.io.dada import (
    parse_ascii_header,
    format_ascii_header,
    observation_from_header,
    header_from_observation,
)

BENCH_HEADER = "/root/reference/Benchmark/header.dada"


class TestAsciiHeader:
    def test_parse_benchmark_header(self):
        with open(BENCH_HEADER) as f:
            hdr = parse_ascii_header(f.read())
        assert hdr["BW"] == "-400"
        assert hdr["FREQ"] == "1382"
        assert hdr["NBIT"] == "8"
        assert hdr["NPOL"] == "2"
        assert hdr["NDIM"] == "1"
        assert hdr["INSTRUMENT"] == "CASPSR"
        assert hdr["SOURCE"] == "J0437-4715"

    def test_comment_stripping(self):
        hdr = parse_ascii_header("KEY value # comment\n# full comment\nK2 v2\n")
        assert hdr == {"KEY": "value", "K2": "v2"}

    def test_format_roundtrip(self):
        keys = {"A": "1", "B": "two"}
        blob = format_ascii_header(keys)
        assert len(blob) == 4096
        assert parse_ascii_header(blob.decode("latin-1")) == keys


class TestObservationFromHeader:
    def test_benchmark_observation(self):
        with open(BENCH_HEADER) as f:
            hdr = parse_ascii_header(f.read())
        obs = observation_from_header(hdr)
        assert obs.nchan == 1
        assert obs.npol == 2
        assert obs.ndim == 1
        assert obs.nbit == 8
        assert obs.bandwidth == -400.0
        assert obs.centre_frequency == 1382.0
        assert obs.state == Signal.NYQUIST
        # TSAMP 0.00125 us -> 800 MHz (Nyquist rate for 400 MHz band)
        assert abs(obs.rate - 800e6) < 1
        assert obs.start_time.days == 55299

    def test_roundtrip(self):
        with open(BENCH_HEADER) as f:
            obs = observation_from_header(parse_ascii_header(f.read()))
        keys = header_from_observation(obs)
        obs2 = observation_from_header(keys)
        assert obs2.nchan == obs.nchan
        assert obs2.bandwidth == obs.bandwidth
        assert abs(obs2.rate - obs.rate) < 1e-3
        assert abs(obs2.start_time - obs.start_time) < 1e-6
        assert obs2.state == obs.state


class TestObservation:
    def test_channel_frequencies(self):
        obs = Observation(nchan=4, centre_frequency=1400.0, bandwidth=400.0)
        # lower edge 1200, channel width 100, not dc_centred -> first at 1250
        assert obs.centre_frequency_of(0) == 1250.0
        assert obs.centre_frequency_of(3) == 1550.0

    def test_channel_frequencies_lsb(self):
        obs = Observation(nchan=4, centre_frequency=1400.0, bandwidth=-400.0)
        assert obs.centre_frequency_of(0) == 1550.0
        assert obs.centre_frequency_of(3) == 1250.0

    def test_nbytes(self):
        obs = Observation(nchan=2, npol=2, ndim=2, nbit=8)
        assert obs.nbytes(100) == 800

    def test_detection_transition(self):
        obs = Observation(npol=2, ndim=2, state=Signal.ANALYTIC)
        st = obs.apply_detection(Signal.STOKES, ndim=4)
        assert st.npol == 1 and st.ndim == 4
        co = obs.apply_detection(Signal.COHERENCE, ndim=1)
        assert co.npol == 4 and co.ndim == 1
        it = obs.apply_detection(Signal.INTENSITY)
        assert it.npol == 1 and it.ndim == 1
