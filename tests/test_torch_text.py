"""PyTorch port of the text side (CMVN, tokenizers, BPE, word segments,
metrics, bucketing) held against the JAX package's modules.

These are host modules copied into the port (it imports nothing of the
JAX package), so the results must be EQUAL, not close: CMVN bit for bit,
token ids, learned symbols and merges, meta dicts, segments and integer
edit counts.
"""

import json

import numpy as np
import pytest

from rnn_transducer_tpu.data import bpe as jbpe
from rnn_transducer_tpu.data import bucketing as jbucket
from rnn_transducer_tpu.data import cmvn as jcmvn
from rnn_transducer_tpu.data import tokenizer as jtok
from rnn_transducer_tpu.decode import metrics as jmetrics
from rnn_transducer_tpu.decode import words as jwords
from rnn_transducer_tpu_torch.data import bpe as tbpe
from rnn_transducer_tpu_torch.data import bucketing as tbucket
from rnn_transducer_tpu_torch.data import cmvn as tcmvn
from rnn_transducer_tpu_torch.data import tokenizer as ttok
from rnn_transducer_tpu_torch.decode import metrics as tmetrics
from rnn_transducer_tpu_torch.decode import words as twords

pytestmark = pytest.mark.quick

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the dog barks at the quick fox",
    "a lazy brown dog sleeps",
    "the fox is quick and the dog is lazy",
    "quick quick quick said the brown fox",
]
TEXTS = ["the lazy fox", "Quick brown dogs!", "  a  b  ", "", "zebra"]


# ---------------------------------- CMVN ----------------------------------

def _stats(dim=8, seed=0):
    rng = np.random.default_rng(seed)
    std = np.abs(rng.normal(size=dim)) + 0.1
    std[0] = 0.0  # a silent bin: the variance floor decides
    return {"mean": rng.normal(size=dim).tolist(), "std": std.tolist()}


def test_cmvn_is_bit_equal():
    rng = np.random.default_rng(1)
    stats = _stats()
    feats = rng.normal(size=(17, 8)).astype(np.float32) * 3
    for a, b in zip(tcmvn.stats_arrays(stats), jcmvn.stats_arrays(stats)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcmvn.apply_cmvn(feats, stats),
                                  jcmvn.apply_cmvn(feats, stats))
    batch = rng.normal(size=(3, 9, 8)).astype(np.float32)
    lens = np.array([9, 4, 0])
    got = tcmvn.apply_cmvn_batch(batch, lens, stats)
    np.testing.assert_array_equal(got, jcmvn.apply_cmvn_batch(batch, lens,
                                                              stats))
    assert np.all(got[1, 4:] == 0) and np.all(got[2] == 0)
    with pytest.raises(ValueError, match="CMVN dim"):
        tcmvn.apply_cmvn(feats[:, :5], stats)


def test_cmvn_save_load_and_compute(tmp_path):
    stats = _stats()
    tcmvn.save_cmvn(stats, str(tmp_path / "s.json"))
    assert tcmvn.load_cmvn(str(tmp_path / "s.json")) == \
        jcmvn.load_cmvn(str(tmp_path / "s.json")) == stats
    with pytest.raises(ValueError, match="'mean' and 'std'"):
        tcmvn.load_cmvn({"mean": [0.0]})
    rng = np.random.default_rng(2)
    recs = []
    for i in range(4):
        p = tmp_path / f"f{i}.npy"
        np.save(p, (rng.normal(size=(int(rng.integers(5, 20)), 8)) * 2
                    + 3).astype(np.float32))
        recs.append({"feats": str(p), "labels": [1, 2]})
    man = tmp_path / "m.jsonl"
    man.write_text("\n".join(json.dumps(r) for r in recs))
    got = tcmvn.compute_cmvn(str(man), 8, device="cpu")
    assert got == jcmvn.compute_cmvn(str(man), 8)


# ------------------------------- tokenizers -------------------------------

@pytest.mark.parametrize("vocab", [40, 60, 1024])
def test_bpe_train_gives_the_jax_symbols_and_merges(vocab):
    got = tbpe.BpeTokenizer.train(CORPUS, vocab)
    want = jbpe.BpeTokenizer.train(CORPUS, vocab)
    assert got.symbols == want.symbols
    assert got.merges == want.merges
    assert got.vocab_size == want.vocab_size
    for text in TEXTS + CORPUS:
        ids = got.encode(text)
        assert ids == want.encode(text)
        assert got.decode(ids) == want.decode(ids)


def test_bpe_save_load_across_packages(tmp_path):
    tbpe.BpeTokenizer.train(CORPUS, 50).save(str(tmp_path / "t.json"))
    jbpe.BpeTokenizer.train(CORPUS, 50).save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    back = tbpe.BpeTokenizer.load(str(tmp_path / "j.json"))
    assert back.encode(CORPUS[0]) == \
        jbpe.BpeTokenizer.load(str(tmp_path / "t.json")).encode(CORPUS[0])
    assert tbpe.WORD_MARK == jbpe.WORD_MARK
    with pytest.raises(ValueError, match="vocab_size"):
        tbpe.BpeTokenizer.train(CORPUS, 5)


def _pairs(tmp_path):
    """(port tokenizer, JAX tokenizer) of each kind."""
    path = tmp_path / "bpe.json"
    jbpe.BpeTokenizer.train(CORPUS, 48).save(str(path))
    return [(ttok.CharTokenizer(), jtok.CharTokenizer()),
            (ttok.CharTokenizer("ab cd'"), jtok.CharTokenizer("ab cd'")),
            (ttok.PhonemeTokenizer(), jtok.PhonemeTokenizer()),
            (ttok.tokenizer_from_spec(f"bpe:{path}"),
             jtok.tokenizer_from_spec(f"bpe:{path}"))]


def test_tokenizers_encode_decode_and_meta_as_jax(tmp_path):
    for port, ref in _pairs(tmp_path):
        assert port.vocab_size == ref.vocab_size
        inputs = ([["aa", "sh", "zz", "h#"], ["b"]]
                  if isinstance(port, ttok.PhonemeTokenizer)
                  else TEXTS + CORPUS)
        for x in inputs:
            ids = port.encode(x)
            assert ids == ref.encode(x)
            assert port.decode(ids + [0, 9999]) == ref.decode(ids + [0, 9999])
            assert ttok.decode_to_text(port, ids) == \
                jtok.decode_to_text(ref, ids)
        meta = ttok.tokenizer_to_meta(port)
        assert meta == jtok.tokenizer_to_meta(ref)
        # a meta written by either package reads the same in the other
        back = ttok.tokenizer_from_meta(json.loads(json.dumps(meta)))
        assert ttok.tokenizer_to_meta(back) == meta
        assert jtok.tokenizer_to_meta(jtok.tokenizer_from_meta(meta)) == meta


def test_tokenizer_specs_and_refusals(tmp_path):
    assert isinstance(ttok.tokenizer_from_spec("char"), ttok.CharTokenizer)
    for spec in ("phone", "timit"):
        assert isinstance(ttok.tokenizer_from_spec(spec),
                          ttok.PhonemeTokenizer)
    assert ttok.TIMIT_PHONES == jtok.TIMIT_PHONES
    with pytest.raises(ValueError, match="unknown tokenizer spec"):
        ttok.tokenizer_from_spec("words")
    with pytest.raises(ValueError, match="unknown tokenizer kind"):
        ttok.tokenizer_from_meta({"kind": "words"})
    with pytest.raises(TypeError, match="not a tokenizer"):
        ttok.tokenizer_to_meta(object())
    tok = ttok.CharTokenizer("xyz")
    tok.save(str(tmp_path / "c.json"))
    assert jtok.CharTokenizer.load(str(tmp_path / "c.json")).alphabet == "xyz"


# ------------------------------ word segments ------------------------------

def _word_cases():
    """The cases of tests/test_words.py: (tokenizer kind, ids, frames,
    confs, hop_s)."""
    char = ttok.CharTokenizer()
    bpe = tbpe.BpeTokenizer.train(["the cat sat on the mat",
                                   "a cat on a mat"] * 4, 40)
    ids_b = bpe.encode("the cat sat")
    return [
        ("char", char.encode(" hi yo "), [2, 10, 14, 20, 31, 40, 55],
         [-.5, -.1, -.2, -.3, -.05, -.4, -.6], 0.01),
        ("char", char.encode("a  b"), [1, 2, 3, 4], None, 0.01),
        ("char", [char.encode("a")[0], 9999, char.encode("b")[0]],
         [1, 2, 3], None, 0.01),
        ("bpe", ids_b, list(range(0, 4 * len(ids_b), 4)),
         [-0.1 * (k + 1) for k in range(len(ids_b))], 0.01),
        ("phone", ttok.PhonemeTokenizer().encode(["aa", "b", "sh"]),
         [5, 9, 13], [-1.0, -2.0, -3.0], 0.02),
    ]


def _tok_pair(kind):
    if kind == "char":
        return ttok.CharTokenizer(), jtok.CharTokenizer()
    if kind == "phone":
        return ttok.PhonemeTokenizer(), jtok.PhonemeTokenizer()
    texts = ["the cat sat on the mat", "a cat on a mat"] * 4
    return (tbpe.BpeTokenizer.train(texts, 40),
            jbpe.BpeTokenizer.train(texts, 40))


def test_word_segments_as_jax():
    for kind, ids, frames, confs, hop in _word_cases():
        port, ref = _tok_pair(kind)
        assert twords.token_pieces(port, ids) == \
            jwords.token_pieces(ref, ids)
        got = twords.word_segments(port, ids, frames, confs, hop_s=hop)
        assert got == jwords.word_segments(ref, ids, frames, confs,
                                           hop_s=hop)
        assert got
    with pytest.raises(TypeError):
        twords.token_pieces(object(), [1])


def test_attach_words_as_jax():
    port, ref = _tok_pair("char")
    payload = {"tokens": port.encode("ab cd"), "frames": [3, 7, 9, 12, 20],
               "confidence": [-.1, -.2, -.3, -.05, -.4]}
    got = twords.attach_words(dict(payload), port, hop_s=0.04)
    assert got == jwords.attach_words(dict(payload), ref, hop_s=0.04)
    assert [w["word"] for w in got["words"]] == ["ab", "cd"]
    assert "words" not in twords.attach_words({"tokens": [1, 2]}, port)
    assert "words" not in twords.attach_words({"tokens": [1],
                                               "frames": [0]}, None)


# --------------------------------- metrics ---------------------------------

def _seqs(seed, n=30, vocab=9, max_len=15):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(0, max_len)).tolist()
            for _ in range(n)]


def test_edit_distance_and_error_rate_equal_jax():
    refs, hyps = _seqs(1), _seqs(2)
    for r, h in zip(refs, hyps):
        assert tmetrics.edit_distance(r, h) == jmetrics.edit_distance(r, h)
    assert tmetrics.edit_distance([], [1, 2]) == 2
    assert tmetrics.edit_distance("kitten", "sitting") == 3
    assert tmetrics.error_rate(refs, hyps) == jmetrics.error_rate(refs, hyps)
    assert tmetrics.error_rate([], []) == 0.0
    # words, as the decode CLI's word WER maps them
    words = [["the", "cat"], ["a", "dog", "sat"]]
    assert tmetrics.error_rate(words, [["the", "hat"], ["dog", "sat"]]) \
        == pytest.approx(2 / 5)


def test_error_report_equals_jax():
    refs, hyps = _seqs(3, n=12), _seqs(4, n=12)
    assert tmetrics.error_report(refs, hyps, top=5) == \
        jmetrics.error_report(refs, hyps, top=5)
    for r, h in zip(refs, hyps):
        assert tmetrics.align_pair(r, h) == jmetrics.align_pair(r, h)


def test_rtf_meter_and_token_lists_as_jax():
    got, want = tmetrics.RtfMeter(), jmetrics.RtfMeter()
    for wall, audio, n in ((0.5, 4.0, 2), (0.25, 1.0, 1), (1.0, 8.0, 4)):
        got.add(wall, audio, n)
        want.add(wall, audio, n)
    assert got.summary() == want.summary()
    toks = np.arange(12).reshape(3, 4)
    lens = np.array([4, 0, 2])
    assert tmetrics.tokens_to_lists(toks, lens) == \
        jmetrics.tokens_to_lists(toks, lens)


# -------------------------------- bucketing --------------------------------

def _examples(seed=5, n=11):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(int(rng.integers(3, 30)), 4)).astype(
        np.float32), rng.integers(1, 9, size=int(rng.integers(1, 9))).astype(
        np.int32)) for _ in range(n)]


@pytest.mark.parametrize("with_valid", [False, True])
def test_bucket_stream_as_jax(with_valid):
    buckets = ((10, 4), (20, 8), (25, 6))
    got = list(tbucket.bucket_stream(_examples(), buckets, 3, blank=0,
                                     with_valid=with_valid))
    want = list(jbucket.bucket_stream(_examples(), buckets, 3, blank=0,
                                      with_valid=with_valid))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    batcher = tbucket.BucketBatcher(buckets, 3)
    for f, l in _examples():
        batcher.add(f, l)
    assert batcher.n_dropped == sum(1 for f, l in _examples()
                                    if len(f) > 25 or len(l) > 8
                                    or (len(f) > 20 and len(l) > 6))
