"""Sentence splitting for original captions and pretrain text.

The reference runs the spaCy ``en_core_web_sm`` senter
(run_video_CapFilt.py:142,166-175; pretrain_video.py:30-44). When spaCy
and its model are available they are used verbatim; offline, a
sentencizer-grade rule set replaces the earlier bare
``(?<=[.!?])\\s+`` regex, handling:

* abbreviations (``Mr.``, ``Dr.``, ``etc.``, ``e.g.``, ``No.`` ...)
  and single-letter initials (``J. Smith``);
* decimals and enumerations (``3.5``, ``v1.2``) — no split without
  following whitespace;
* ellipses: ``...`` continues into a lowercase word, splits before an
  uppercase one;
* closing quotes/brackets attach to the PRECEDING sentence
  (``He said "stop." Then...`` keeps the quote with ``stop.``);
* lowercase sentence starts DO split (caption corpora are lowercase
  sentence streams, and the trained senter splits them).

Which of the two serves is settled on the first call in a process and
kept (`_reset_backend` starts over). A one-time warning is emitted when the
fallback (not spaCy) serves a byte-parity-sensitive path, since exact
parity with the trained senter is not guaranteed.
"""

from __future__ import annotations

import re
import warnings

# common abbreviations, lowercase, WITHOUT the trailing period; multi-part
# ones like e.g/i.e/u.s keep their inner periods
_ABBREVS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "mt", "capt", "gen",
    "sen", "rep", "gov", "pres", "rev", "hon", "vs", "v", "etc", "e.g",
    "i.e", "cf", "al", "fig", "figs", "no", "nos", "vol", "vols", "pp",
    "p", "ed", "eds", "inc", "ltd", "co", "corp", "dept", "univ", "assn",
    "approx", "est", "min", "max", "sec", "jan", "feb", "mar", "apr",
    "jun", "jul", "aug", "sep", "sept", "oct", "nov", "dec", "mon", "tue",
    "wed", "thu", "fri", "sat", "sun", "u.s", "u.k", "u.n", "d.c", "a.m",
    "p.m", "b.c", "a.d", "ft", "in", "oz", "lb", "lbs", "sq", "ph.d",
    "m.d", "b.a", "m.a", "d.d.s",
}

# candidate boundary: terminal punctuation (+ attached closers) then space
_BOUNDARY_RE = re.compile(r"([.!?…]+)([\"'”’)\]]*)(\s+)")

_warned = False
_UNRESOLVED = object()
_backend = _UNRESOLVED  # see _resolve_backend


def _warn_fallback_once() -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "spaCy en_core_web_sm is unavailable: sentence splitting uses the "
            "built-in rule-based sentencizer. Output may differ from the "
            "reference's trained senter on unusual punctuation "
            "(byte-parity-sensitive paths: keep_original_caption=True CapFilt, "
            "pretrain sentence tokenization).",
            stacklevel=3,
        )


def _is_abbreviation(before: str) -> bool:
    """Word immediately preceding a '.' (period not included)."""
    word = before.rstrip(".")
    if not word:
        return False
    low = word.lower()
    if low in _ABBREVS:
        return True
    # single-letter initials: 'J' in 'J. Smith', or dotted runs 'U.S'
    if len(word) == 1 and word.isalpha():
        return True
    if re.fullmatch(r"(?:[A-Za-z]\.)+[A-Za-z]", word):
        return True
    return False


def split_sentences_rules(text: str) -> list[str]:
    """Rule-based sentence splitter (see module docstring)."""
    sentences: list[str] = []
    start = 0
    for m in _BOUNDARY_RE.finditer(text):
        punct, closers, _ws = m.group(1), m.group(2), m.group(3)
        end = m.start() + len(punct) + len(closers)  # closers attach left
        following = text[m.end():]
        next_word = following[:1]

        if "." in punct and "!" not in punct and "?" not in punct and "…" not in punct:
            is_ellipsis = len(punct) >= 3 or punct == ".."
            prev = text[max(0, start):m.start()]
            last_word = prev.split()[-1] if prev.split() else ""
            if is_ellipsis:
                # '...' continues into lowercase, splits before upper/digit
                if next_word and not (next_word.isupper() or next_word.isdigit()):
                    continue
            else:
                # NOTE: a lowercase next word does NOT suppress the split —
                # caption corpora are lowercase sentence streams ("a man
                # sings. a woman dances") and the trained senter splits them
                if _is_abbreviation(last_word):
                    continue
        seg = text[start:end].strip()
        if seg:
            sentences.append(seg)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences


def _resolve_backend():
    """The spaCy pipeline, or None where spaCy or its model does not load:
    tried on the first call in the process and remembered, since a failed
    import searches the whole import path again each time it is tried."""
    global _backend
    if _backend is _UNRESOLVED:
        try:  # pragma: no cover - optional dependency
            import spacy

            _backend = spacy.load("en_core_web_sm", disable=["ner", "tagger", "lemmatizer"])
        except Exception:
            _backend = None
    return _backend


def _reset_backend() -> None:
    """Back to the first call's state: no backend resolved, no warning given."""
    global _backend, _warned
    _backend = _UNRESOLVED
    _warned = False


def split_sentences(text: str) -> list[str]:
    """spaCy senter when available (reference parity), rules otherwise."""
    nlp = _resolve_backend()
    if nlp is not None:  # pragma: no cover - optional dependency
        return [s.text.strip() for s in nlp(text).sents]
    _warn_fallback_once()
    return split_sentences_rules(text)
