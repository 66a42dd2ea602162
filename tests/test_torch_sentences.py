"""The port's sentence splitter resolves its backend once a process: spaCy's
`en_core_web_sm` when it loads, the rule-based sentencizer otherwise. Its
import is tried on the first call only, the fallback warns once, a loaded
pipeline is loaded once and serves CapFilt's original captions and the
pretraining frame selection alike, and `_reset_backend` restores the
first call's state.
"""

import builtins
import sys
import types
import warnings

import pytest

from vidil_tpu_torch.pipeline import sentences as S
from vidil_tpu_torch.pipeline.capfilt import original_caption_sentences
from vidil_tpu_torch.train.frame_selection import sentence_tokenization

TEXTS = ["A man runs. Dr. Smith waves!\nok", "a dog plays... It jumps. e.g. here", "x",
         "two sentences. no split in 3.5 here"]


@pytest.fixture(autouse=True)
def _first_call_state():
    S._reset_backend()
    yield
    S._reset_backend()


@pytest.fixture
def spacy_imports(monkeypatch):
    """Counts the attempts to import spaCy."""
    attempts = []
    real = builtins.__import__

    def counting(name, *args, **kwargs):
        if name == "spacy":
            attempts.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", counting)
    return attempts


def _fake_spacy(loads):
    """A spaCy whose pipeline splits at '|' and whose `load` is counted."""
    class Sent:
        def __init__(self, text):
            self.text = text

    def nlp(text):
        return types.SimpleNamespace(sents=[Sent(p) for p in text.split("|")])

    def load(name, disable=()):
        loads.append((name, tuple(disable)))
        return nlp

    mod = types.ModuleType("spacy")
    mod.load = load
    return mod


def test_without_spacy_the_import_is_tried_once_and_the_rules_serve(monkeypatch, spacy_imports):
    monkeypatch.setitem(sys.modules, "spacy", None)  # absent: import raises
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = [S.split_sentences(t) for t in TEXTS * 5]
    assert got == [S.split_sentences_rules(t) for t in TEXTS * 5]
    assert len(spacy_imports) == 1
    assert len(rec) == 1 and "sentencizer" in str(rec[0].message)


def test_a_loaded_spacy_is_loaded_once_and_its_sentences_returned(monkeypatch):
    loads = []
    monkeypatch.setitem(sys.modules, "spacy", _fake_spacy(loads))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert S.split_sentences(" a | b c ") == ["a", "b c"]
        assert S.split_sentences("one") == ["one"]
        # both callers of the splitter share its backend
        assert original_caption_sentences(["first part|second part\nthird"], True) == [
            "first part", "second part. third"]
        assert sentence_tokenization("Some Words|more words") == ["some words", "more words"]
    assert loads == [("en_core_web_sm", ("ner", "tagger", "lemmatizer"))]
    assert rec == []


def test_reset_restores_the_first_call_state(monkeypatch, spacy_imports):
    loads = []
    monkeypatch.setitem(sys.modules, "spacy", _fake_spacy(loads))
    assert S.split_sentences("a|b") == ["a", "b"]
    monkeypatch.setitem(sys.modules, "spacy", None)
    assert S.split_sentences("a|b") == ["a", "b"]  # the loaded pipeline is kept
    assert len(spacy_imports) == 1
    S._reset_backend()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert S.split_sentences("a man sings. a woman dances") == [
            "a man sings.", "a woman dances"]
        S.split_sentences("again")
    assert len(spacy_imports) == 2 and len(loads) == 1
    assert len(rec) == 1
