"""The seeded composer: composed streams parse frame for frame, and the
reference decodes each part as it decodes the part alone."""
import numpy as np

from conftest import ROOT


def clips(config="cbr128", n_frames=None):
    from mp3bench import compose, spec
    from conftest import cut_clips
    cs = compose.load_corpus(spec.load_json(f"{ROOT}/benchmark/configs/{config}.json"), ROOT)
    return cut_clips(cs, n_frames) if n_frames else cs


def test_a_composed_stream_parses_frame_for_frame():
    from mp3bench import compose
    from mp3bench.reference.container import frames as fr
    from mp3bench.reference.container.xing import parse_stream_info
    a, b = clips(n_frames=30)[2:4]
    data = compose.compose([a, b])
    index = fr.scan_frames(np.frombuffer(data, np.uint8))
    assert index.n_frames == 1 + a.n_audio_frames + b.n_audio_frames
    assert index.junk_bytes == 0 and index.resyncs == 0
    offs = list(index.offsets) + [len(data)]
    frames = [data[x:y] for x, y in zip(offs, offs[1:])]
    for part, got in ((a, frames[1:1 + a.n_audio_frames]),
                      (b, frames[1 + a.n_audio_frames:])):
        assert b"".join(got) == part.audio
    info = parse_stream_info(data, 0, index.headers[0])
    assert info.gapless and info.n_bytes == len(data)
    assert info.n_frames == a.n_audio_frames + b.n_audio_frames
    assert (info.encoder_delay, info.encoder_padding) == (a.delay, b.padding)


def test_the_reference_decodes_each_part_as_the_part_alone():
    """Symbols equal granule for granule; PCM equal from each later part's
    third granule on (its first granule's overlap-add, and the synthesis
    history after it, carry the part before)."""
    from mp3bench import compose, reference
    from mp3bench.reference import dsp
    parts = clips("cbr320", n_frames=24)[5:8]
    st, _info = reference.load(compose.compose(parts))
    pcm = dsp.granule_chain(st).numpy()
    g = 0
    for i, p in enumerate(parts):
        alone, _ = reference.load(compose.compose([p]))
        n = alone.n_granules
        for f in ("is_", "exp", "block_type", "mixed", "smode", "errors"):
            assert np.array_equal(getattr(st, f)[g:g + n], getattr(alone, f))
        skip = 0 if i == 0 else 2
        want = dsp.granule_chain(alone).numpy()[skip * 576:]
        np.testing.assert_allclose(pcm[(g + skip) * 576:(g + n) * 576], want,
                                   rtol=0, atol=1e-12)
        g += n
    assert g == st.n_granules


def test_every_clip_is_used_equally_often():
    from mp3bench import compose
    plan = compose.plan(64, 2, 8, compose.rng(2 ** 40 + 3, 1, 0))
    counts = np.bincount(np.ravel(plan), minlength=8)
    assert len(plan) == 64 and all(len(p) == 2 for p in plan)
    assert (counts == 16).all()
    assert plan != compose.plan(64, 2, 8, compose.rng(2 ** 40 + 4, 1, 0))


def test_the_corpus_matches_its_manifest():
    from mp3bench import compose, spec
    for config in ("cbr128", "cbr320"):
        cfg = spec.load_json(f"{ROOT}/benchmark/configs/{config}.json")
        cs = compose.load_corpus(cfg, ROOT)
        assert len(cs) == 8 and len({c.audio for c in cs}) == 8
        assert all(c.samples == 441000 and c.sample_rate == 44100 for c in cs)
