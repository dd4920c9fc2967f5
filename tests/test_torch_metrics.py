"""The port's NLG metrics (retr_tpu_torch/metrics, a copy of retr_tpu/metrics)
held against retr_tpu's: BLEU 1-4, METEOR, ROUGE-L and CIDEr on the fixed
strings of tests/test_metrics.py and on random corpora from a seed, corpus
and per-segment scores, with ``metrics_to_omit`` and METEOR's resources.
Floats must be equal, not close: the code is the same."""

import numpy as np
import pytest

from retr_tpu.metrics import NLGEval as JNLGEval
from retr_tpu.metrics import bleu as jbleu
from retr_tpu.metrics import cider as jcider
from retr_tpu.metrics import meteor as jmeteor
from retr_tpu.metrics import porter as jporter
from retr_tpu.metrics import rouge as jrouge
from retr_tpu_torch.metrics import NLGEval
from retr_tpu_torch.metrics import bleu, cider, meteor, porter, rouge

# (references per segment, hypotheses), from tests/test_metrics.py
FIXED = [
    ([["the cat sat on the mat"], ["a dog runs fast"]], ["the cat sat on the mat", "a dog runs fast"]),
    ([["the cat"]], ["the the cat"]),
    ([["the cat sat on the mat"]], ["the cat"]),
    ([["the red dog", "a red dog"], ["a small cat", "the small cat"]], ["the red dog", "a small cat"]),
    ([["the red dog", "a red dog"], ["a small cat", "the small cat"]], ["green banana here", "purple elephant there"]),
    ([["the red dog on the mat"], ["a small cat under the chair"]], ["the red dog", "a small cat"]),
    ([["the cat sat"]], ["the cat"]),
    ([["completely different words", "the cat sat"]], ["the cat sat"]),
    ([["the dog runs"]], ["the dog running"]),
    ([["he gave up the fight"]], ["he surrendered the fight"]),
    ([["The woman's red coat."], ["It costs 3.50, right?"]], ["the woman's red coat", "it costs 3.50."]),
    ([["red cat"]], ["red dog"]),
]

WORDS = ("the a man woman dog cat red blue left right on in next to big small shirt hat "
         "table chair running sitting holding").split()


def _random_corpus(seed, n=40, refs=3):
    rng = np.random.default_rng(seed)

    def sent():
        return " ".join(rng.choice(WORDS, size=int(rng.integers(1, 9))))

    return [[sent() for _ in range(refs)] for _ in range(n)], [sent() for _ in range(n)]


def _scores(mods, refs, hyps, resources=None):
    b, c, m, r = mods
    return {"bleu": b.corpus_bleu(refs, hyps), "cider": c.cider(refs, hyps),
            "meteor": m.meteor(refs, hyps, resources=resources), "rouge": r.rouge_l(refs, hyps)}


PORT, REF = (bleu, cider, meteor, rouge), (jbleu, jcider, jmeteor, jrouge)


@pytest.mark.parametrize("case", range(len(FIXED)))
def test_scorers_equal_on_fixed_strings(case):
    refs, hyps = FIXED[case]
    assert _scores(PORT, refs, hyps) == _scores(REF, refs, hyps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nlgeval_equal_on_a_random_corpus(seed):
    refs, hyps = _random_corpus(seed)
    transposed = list(map(list, zip(*refs)))
    got = NLGEval(no_skipthoughts=True, no_glove=True).compute_metrics(transposed, hyps)
    want = JNLGEval(no_skipthoughts=True, no_glove=True).compute_metrics(transposed, hyps)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
    assert got == want
    assert _scores(PORT, refs, hyps) == _scores(REF, refs, hyps)   # per-segment scores too


@pytest.mark.parametrize("omit", [["METEOR", "CIDEr"], ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"],
                                  ["Bleu_4", "ROUGE_L"]])
def test_metrics_to_omit_equal(omit):
    refs, hyps = _random_corpus(7, n=12, refs=2)
    transposed = list(map(list, zip(*refs)))
    got = NLGEval(metrics_to_omit=omit).compute_metrics(transposed, hyps)
    want = JNLGEval(metrics_to_omit=omit).compute_metrics(transposed, hyps)
    assert got == want and not set(omit) & set(got)


def test_meteor_resources_and_drop_ins_equal(tmp_path, monkeypatch):
    syn = tmp_path / "synsets.txt"
    syn.write_text("cat feline\ndog canine hound\n")
    par = tmp_path / "paraphrases.txt"
    par.write_text("gave up ||| surrendered\n")
    words = tmp_path / "en.words"
    words.write_text("red\ncat\n")
    refs, hyps = [["the feline sat"], ["he gave up the fight"], ["red cat"]], \
        ["the cat sat", "he surrendered the fight", "red dog"]
    res, jres = meteor.MeteorResources.from_files(str(syn), str(par)), \
        jmeteor.MeteorResources.from_files(str(syn), str(par))
    assert meteor.meteor(refs, hyps, resources=res) == jmeteor.meteor(refs, hyps, resources=jres)
    monkeypatch.setenv("RETR_METEOR_SYNONYMS", str(syn))
    monkeypatch.setenv("RETR_METEOR_PARAPHRASES", str(par))
    monkeypatch.setenv("RETR_METEOR_FUNCTION_WORDS", str(words))
    transposed = list(map(list, zip(*refs)))
    got, want = NLGEval().compute_metrics(transposed, hyps), JNLGEval().compute_metrics(transposed, hyps)
    assert got == want
    monkeypatch.delenv("RETR_METEOR_SYNONYMS")
    monkeypatch.delenv("RETR_METEOR_PARAPHRASES")
    assert NLGEval().compute_metrics(transposed, hyps)["METEOR"] != got["METEOR"]


def test_porter_stem_and_norm_tokenize_equal():
    words = ["caresses", "ponies", "cats", "agreed", "plastered", "motoring", "happy", "relational",
             "adjustable", "effective", "running", "sitting", "holding", "generalization"]
    assert [porter.porter_stem(w) for w in words] == [jporter.porter_stem(w) for w in words]
    texts = ["The woman's red coat.", "a 5-way tie — “wow”", "fish &amp; chips", ".5 or 5,"]
    assert [meteor.norm_tokenize(t) for t in texts] == [jmeteor.norm_tokenize(t) for t in texts]
