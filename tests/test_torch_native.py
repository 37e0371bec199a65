"""The port's native host runtime (``indic_cl_asr_torch/utils/native.py``
over ``csrc/host/*.cpp``) against the JAX package's (``native/*.cpp``) and
the port's Python paths, as tests/test_native.py holds the JAX one.

Tolerances: distances equal; 16 kHz mono PCM16 batches byte-equal to the
JAX loader's and to the Python reader's; a resampled batch byte-equal to
the JAX loader's (the same C++), and within 1e-6 of the Python reader's
``resample_linear`` (numpy's interp in f64 against the C++'s f64 lerp of
f32 samples, both rounded to f32 once: at most an f32 rounding step of
values below 1); ``_assemble`` batches equal the JAX package's array for
array.
"""

import os
import subprocess

import numpy as np
import pytest

from indic_cl_asr_tpu.audio.io import load_audio as jax_load_audio
from indic_cl_asr_tpu.audio.io import write_wav
from indic_cl_asr_tpu.data.manifest import ManifestEntry as JaxEntry
from indic_cl_asr_tpu.data.pipeline import BucketSpec as JaxBuckets
from indic_cl_asr_tpu.data.pipeline import _assemble as jax_assemble
from indic_cl_asr_tpu.train.metrics import edit_distance_py as jax_edit_distance_py
from indic_cl_asr_tpu.train.metrics import wer as jax_wer
from indic_cl_asr_tpu.utils import native as jax_native
from indic_cl_asr_torch.audio.io import load_audio, read_wav
from indic_cl_asr_torch.data import pipeline
from indic_cl_asr_torch.data.manifest import ManifestEntry
from indic_cl_asr_torch.data.pipeline import BucketSpec, _assemble
from indic_cl_asr_torch.data.tokenizer import CharTokenizer, MultilingualTokenizer
from indic_cl_asr_torch.train import metrics
from indic_cl_asr_torch.utils import native

from .synth import make_texts


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    """The JAX package's native library, compiled from its sources
    (``native/*.cpp``) with the port's flags into this module's own
    temporary directory, and loaded through ``jax_native.get_lib``. Left
    to itself, the JAX module compiles at first use straight onto
    ``native/libindic_native.so``; under xdist another test process may be
    compiling there at that moment, and a load of its partial file fails
    for the life of the process. No other process writes this copy."""
    out = tmp_path_factory.mktemp("jax_native") / "libindic_native.so"
    srcs = [os.path.join(jax_native._NATIVE_DIR, n) for n in ("editdistance.cpp",
                                                              "audio_loader.cpp")]
    subprocess.run([*native.COMPILE, *srcs, "-shared", "-lpthread", "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(out))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        assert jax_native.get_lib() is not None
        yield


def _pairs(rng, n=50):
    return [([str(x) for x in rng.integers(0, 8, rng.integers(0, 20))],
             [str(x) for x in rng.integers(0, 8, rng.integers(0, 20))]) for _ in range(n)]


def test_edit_distance_matches_jax_and_the_plain_version(rng):
    cases = [([], []), (list("kitten"), list("sitting")), (["a", "b", "c"], ["a", "x", "c", "d"]),
             (["x"], []), ([], ["y", "z"]), (["ab", "ab", "a"], ["a", "ab"])] + _pairs(rng, 20)
    for a, b in cases:
        want = jax_edit_distance_py(a, b)
        assert native.edit_distance_native(a, b) == want
        assert metrics.edit_distance_py(a, b) == want
        assert jax_native.edit_distance_native(a, b) == want
    # WER goes through the native distance, as the JAX package's does
    assert metrics.edit_distance is native.edit_distance_native
    refs = [" ".join(a) for a, _ in cases]
    hyps = [" ".join(b) for _, b in cases]
    assert metrics.wer(refs, hyps) == jax_wer(refs, hyps)


@pytest.mark.parametrize("threads", [1, 4])
def test_edit_distance_batch_matches_jax(rng, threads):
    pairs = _pairs(rng)
    got = native.edit_distance_batch(pairs, n_threads=threads)
    assert got == jax_native.edit_distance_batch(pairs, n_threads=threads)
    assert got == [jax_edit_distance_py(a, b) for a, b in pairs]
    assert native.edit_distance_batch([([], [])]) == [0]


def _wavs(tmp_path, rng, sizes, sr=16000):
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"{i}.wav")
        write_wav(p, (0.4 * rng.standard_normal(n)).astype(np.float32), sr)
        paths.append(p)
    return paths


def test_wav_batch_is_byte_equal_to_jax_and_the_python_reader(tmp_path, rng):
    paths = _wavs(tmp_path, rng, [1600, 4000, 8000, 9000])
    batch, lengths = native.load_wav_batch_native(paths, max_samples=8000)
    jbatch, jlengths = jax_native.load_wav_batch_native(paths, max_samples=8000)
    assert batch.dtype == np.float32 and batch.shape == (4, 8000)
    assert batch.tobytes() == jbatch.tobytes() and lengths.tolist() == jlengths.tolist()
    assert lengths.tolist() == [1600, 4000, 8000, 8000]
    for i, p in enumerate(paths):
        ref, sr = read_wav(p)
        n = lengths[i]
        assert sr == 16000 and batch[i, :n].tobytes() == ref[:n].tobytes()
        assert not batch[i, n:].any()


def test_wav_batch_resamples_and_flags_a_bad_file(tmp_path, rng):
    good = _wavs(tmp_path, rng, [8000], sr=8000)[0]
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    batch, lengths = native.load_wav_batch_native([good, bad], max_samples=20000)
    jbatch, jlengths = jax_native.load_wav_batch_native([good, bad], max_samples=20000)
    assert batch.tobytes() == jbatch.tobytes() and lengths.tolist() == jlengths.tolist()
    assert lengths[1] == -1 and not batch[1].any()
    ref = load_audio(good)  # resample_linear, 8 kHz -> 16 kHz
    assert lengths[0] == len(ref) == 16000
    np.testing.assert_allclose(batch[0, :16000], ref, rtol=0, atol=1e-6)
    assert np.abs(batch[0]).max() > 0


def _manifest(tmp_path, rng, n=7):
    sizes = rng.integers(8000, 40000, n)  # 0.5-2.5 s: some cut at the 1.5 s bucket
    paths = _wavs(tmp_path, rng, sizes)
    texts = make_texts("hindi", n, seed=3)
    return [(p, float(s) / 16000, t) for p, s, t in zip(paths, sizes, texts)]


def test_assemble_matches_jax_on_a_wav_manifest(tmp_path, rng, monkeypatch):
    rows = _manifest(tmp_path, rng)
    tok = MultilingualTokenizer({"hindi": CharTokenizer.train(make_texts("hindi", 50))})
    spec = BucketSpec(boundaries_sec=(1.5,), max_tokens=(24,))
    jspec = JaxBuckets(boundaries_sec=(1.5,), max_tokens=(24,))
    entries = [ManifestEntry(audio_filepath=p, duration=d, text=t, lang="hindi")
               for p, d, t in rows]
    jentries = [JaxEntry(audio_filepath=p, duration=d, text=t, lang="hindi") for p, d, t in rows]
    calls = []
    monkeypatch.setattr(pipeline, "load_wav_batch_native",
                        lambda *a: calls.append(a) or native.load_wav_batch_native(*a))
    got = _assemble(entries, 5, 0, spec, tok, {"hindi": 0}, 0, load_audio, None)
    assert len(calls) == 1  # one native call for the batch
    want = jax_assemble(jentries, 5, 0, jspec, tok, {"hindi": 0}, 0, jax_load_audio, None)
    for name in ("audio", "audio_len", "tokens", "token_len", "lang_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got.n_real == want.n_real == 5 and got.texts == want.texts
    assert (got.audio_len == np.minimum([r[1] * 16000 for r in rows], 24000)).all()
    # the Python reader, given as the loader, gives the same batch
    py = _assemble(entries, 5, 0, spec, tok, {"hindi": 0}, 0, lambda p: load_audio(p), None)
    assert py.audio.tobytes() == got.audio.tobytes()
    assert py.audio_len.tobytes() == got.audio_len.tobytes()


def test_assemble_reads_a_flagged_batch_through_the_python_reader(tmp_path, rng):
    """A file the C++ decoder flags (-1) sends the batch to ``load_audio``,
    as in the JAX package: a WAV the Python reader cannot read either
    raises its error there, in both packages."""
    rows = _manifest(tmp_path, rng, n=2)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFF....WAVEjunk")
    tok = MultilingualTokenizer({"hindi": CharTokenizer.train(make_texts("hindi", 50))})
    entries = [ManifestEntry(audio_filepath=p, duration=1.0, text="", lang="hindi")
               for p in (rows[0][0], bad)]
    jentries = [JaxEntry(audio_filepath=e.audio_filepath, duration=1.0, text="", lang="hindi")
                for e in entries]
    with pytest.raises(Exception) as port_err:
        _assemble(entries, 2, 0, BucketSpec(), tok, {"hindi": 0}, 0, load_audio, None)
    with pytest.raises(Exception) as jax_err:
        jax_assemble(jentries, 2, 0, JaxBuckets(), tok, {"hindi": 0}, 0, jax_load_audio, None)
    assert type(port_err.value) is type(jax_err.value)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    missing = tmp_path / "no_such_source.cpp"
    monkeypatch.setattr(native, "SOURCES", (missing,))
    with pytest.raises(FileNotFoundError):  # the hash reads the sources
        native.library_path()
    missing.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native host library failed") as err:
        native.get_lib()
    assert "error" in str(err.value)
    assert not any((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "COMPILE", (str(tmp_path / "no_compiler"),))
    with pytest.raises(RuntimeError, match="cannot run the host compiler"):
        native.build()


def test_the_library_is_built_from_the_ports_sources():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libindic_host-")
    assert all(s.parent.name == "host" and s.exists() for s in native.SOURCES)
    assert os.path.samefile(native.get_lib()._name, path)
