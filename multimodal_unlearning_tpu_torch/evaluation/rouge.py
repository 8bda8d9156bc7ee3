# Derived from rouge_score 0.1.2 (rouge_score/tokenize.py, rouge_scorer.py,
# scoring.py; Copyright 2022 The rouge_score Authors) and from NLTK 3.10's
# Porter stemmer (nltk/stem/porter.py; Copyright (C) 2001-2024 NLTK
# Project), both under the Apache License, Version 2.0:
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
#
# Changed: only what ``RougeScorer(["rouge1", "rougeL"], use_stemmer=True)``
# runs is kept -- the tokenizer, unigram and LCS scores, and the stemmer in
# its default NLTK_EXTENSIONS mode.
"""ROUGE-1 and ROUGE-L with the Porter stemmer, as the evaluator scores
generations.

The JAX package scores with ``rouge_score.RougeScorer(["rouge1", "rougeL"],
use_stemmer=True)``, which stems with NLTK's ``PorterStemmer()``.  Neither
package is installed beside the port on the card's machine, so this module
is a copy of the parts that scorer runs; ``tests/test_torch_rouge_metrics.py``
holds it word for word against both packages.
"""

from __future__ import annotations

import collections
import re
from typing import NamedTuple

__all__ = ["PorterStemmer", "Score", "RougeScorer", "tokenize"]


class PorterStemmer:
    """NLTK's ``PorterStemmer()``: Porter's algorithm with Martin Porter's
    and NLTK's extensions (NLTK's ``NLTK_EXTENSIONS`` mode, its default).
    Where the extensions depart from the 1980 paper: a pool of irregular
    forms, ``-ies``/``-ied`` of four letters, ``y -> i`` only after a
    consonant, ``-alli``/``-bli``/``-fulli``/``-logi`` in step 2, and
    words of one or two letters left alone."""

    _IRREGULAR = {
        "sky": ["sky", "skies"],
        "die": ["dying"],
        "lie": ["lying"],
        "tie": ["tying"],
        "news": ["news"],
        "inning": ["innings", "inning"],
        "outing": ["outings", "outing"],
        "canning": ["cannings", "canning"],
        "howe": ["howe"],
        "proceed": ["proceed"],
        "exceed": ["exceed"],
        "succeed": ["succeed"],
    }

    def __init__(self):
        self.pool = {form: key for key, forms in self._IRREGULAR.items() for form in forms}
        self.vowels = frozenset("aeiou")

    def _is_consonant(self, word, i):
        if word[i] in self.vowels:
            return False
        if word[i] == "y":
            negate = False
            while i > 0 and word[i] == "y":
                negate = not negate
                i -= 1
            return (word[i] not in self.vowels) != negate
        return True

    def _measure(self, stem):
        cv = "".join("c" if self._is_consonant(stem, i) else "v" for i in range(len(stem)))
        return cv.count("vc")

    def _has_positive_measure(self, stem):
        return self._measure(stem) > 0

    def _contains_vowel(self, stem):
        return any(not self._is_consonant(stem, i) for i in range(len(stem)))

    def _ends_double_consonant(self, word):
        return len(word) >= 2 and word[-1] == word[-2] and self._is_consonant(word, len(word) - 1)

    def _ends_cvc(self, word):
        return (
            len(word) >= 3
            and self._is_consonant(word, len(word) - 3)
            and not self._is_consonant(word, len(word) - 2)
            and self._is_consonant(word, len(word) - 1)
            and word[-1] not in ("w", "x", "y")
        ) or (
            len(word) == 2 and not self._is_consonant(word, 0) and self._is_consonant(word, 1)
        )

    @staticmethod
    def _replace_suffix(word, suffix, replacement):
        return word + replacement if suffix == "" else word[: -len(suffix)] + replacement

    def _apply_rule_list(self, word, rules):
        """The first rule whose suffix the word ends with decides: its
        replacement if its condition holds on the stem, else the word
        unchanged.  The suffix ``*d`` stands for a double consonant."""
        for suffix, replacement, condition in rules:
            if suffix == "*d" and self._ends_double_consonant(word):
                stem = word[:-2]
                return stem + replacement if condition is None or condition(stem) else word
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                return stem + replacement if condition is None or condition(stem) else word
        return word

    def _step1a(self, word):
        if word.endswith("ies") and len(word) == 4:
            return self._replace_suffix(word, "ies", "ie")
        return self._apply_rule_list(word, [
            ("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None), ("s", "", None)])

    def _step1b(self, word):
        if word.endswith("ied"):
            return self._replace_suffix(word, "ied", "ie" if len(word) == 4 else "i")
        if word.endswith("eed"):
            stem = self._replace_suffix(word, "eed", "")
            return stem + "ee" if self._measure(stem) > 0 else word
        for suffix in ("ed", "ing"):
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                if self._contains_vowel(stem):
                    break
        else:
            return word
        return self._apply_rule_list(stem, [
            ("at", "ate", None),
            ("bl", "ble", None),
            ("iz", "ize", None),
            ("*d", stem[-1], lambda s: stem[-1] not in ("l", "s", "z")),
            ("", "e", lambda s: self._measure(s) == 1 and self._ends_cvc(s)),
        ])

    def _step1c(self, word):
        return self._apply_rule_list(word, [
            ("y", "i", lambda s: len(s) > 1 and self._is_consonant(s, len(s) - 1))])

    def _step2(self, word):
        if word.endswith("alli") and self._has_positive_measure(
                self._replace_suffix(word, "alli", "")):
            return self._step2(self._replace_suffix(word, "alli", "al"))
        m = self._has_positive_measure
        return self._apply_rule_list(word, [
            ("ational", "ate", m), ("tional", "tion", m), ("enci", "ence", m),
            ("anci", "ance", m), ("izer", "ize", m), ("bli", "ble", m), ("alli", "al", m),
            ("entli", "ent", m), ("eli", "e", m), ("ousli", "ous", m), ("ization", "ize", m),
            ("ation", "ate", m), ("ator", "ate", m), ("alism", "al", m), ("iveness", "ive", m),
            ("fulness", "ful", m), ("ousness", "ous", m), ("aliti", "al", m),
            ("iviti", "ive", m), ("biliti", "ble", m), ("fulli", "ful", m),
            ("logi", "log", lambda s: m(word[:-3])),
        ])

    def _step3(self, word):
        m = self._has_positive_measure
        return self._apply_rule_list(word, [
            ("icate", "ic", m), ("ative", "", m), ("alize", "al", m), ("iciti", "ic", m),
            ("ical", "ic", m), ("ful", "", m), ("ness", "", m)])

    def _step4(self, word):
        def m(s):
            return self._measure(s) > 1

        return self._apply_rule_list(word, [
            ("al", "", m), ("ance", "", m), ("ence", "", m), ("er", "", m), ("ic", "", m),
            ("able", "", m), ("ible", "", m), ("ant", "", m), ("ement", "", m),
            ("ment", "", m), ("ent", "", m), ("ion", "", lambda s: m(s) and s[-1] in ("s", "t")),
            ("ou", "", m), ("ism", "", m), ("ate", "", m), ("iti", "", m), ("ous", "", m),
            ("ive", "", m), ("ize", "", m)])

    def _step5a(self, word):
        if word.endswith("e"):
            stem = self._replace_suffix(word, "e", "")
            if self._measure(stem) > 1:
                return stem
            if self._measure(stem) == 1 and not self._ends_cvc(stem):
                return stem
        return word

    def _step5b(self, word):
        return self._apply_rule_list(word, [("ll", "l", lambda s: self._measure(word[:-1]) > 1)])

    def stem(self, word: str) -> str:
        stem = word.lower()
        if stem in self.pool:
            return self.pool[stem]
        if len(word) <= 2:
            return stem
        for step in (self._step1a, self._step1b, self._step1c, self._step2, self._step3,
                     self._step4, self._step5a, self._step5b):
            stem = step(stem)
        return stem


_NON_ALPHANUM = re.compile(r"[^a-z0-9]+")
_SPACES = re.compile(r"\s+")
_VALID_TOKEN = re.compile(r"^[a-z0-9]+$")


def tokenize(text: str, stemmer: PorterStemmer | None) -> list[str]:
    """rouge_score's tokenizer: lowercase, every run of characters outside
    [a-z0-9] becomes a space, split, stem tokens longer than 3 characters,
    keep the non-empty [a-z0-9]+ tokens."""
    tokens = _SPACES.split(_NON_ALPHANUM.sub(" ", text.lower()))
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if _VALID_TOKEN.match(x)]


class Score(NamedTuple):
    precision: float
    recall: float
    fmeasure: float


def _fmeasure(precision, recall):
    return 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0


def _score_unigrams(target, prediction) -> Score:
    t, p = collections.Counter(target), collections.Counter(prediction)
    hits = sum(min(n, p[tok]) for tok, n in t.items())
    precision = hits / max(sum(p.values()), 1)
    recall = hits / max(sum(t.values()), 1)
    return Score(precision, recall, _fmeasure(precision, recall))


def _lcs_length(ref, can) -> int:
    prev = [0] * (len(can) + 1)
    for r in ref:
        cur = [0]
        for j, c in enumerate(can, 1):
            cur.append(prev[j - 1] + 1 if r == c else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def _score_lcs(target, prediction) -> Score:
    if not target or not prediction:
        return Score(precision=0, recall=0, fmeasure=0)
    n = _lcs_length(target, prediction)
    precision, recall = n / len(prediction), n / len(target)
    return Score(precision, recall, _fmeasure(precision, recall))


class RougeScorer:
    """``rouge_score.rouge_scorer.RougeScorer`` for the types ``rouge1`` and
    ``rougeL`` with the default tokenizer: ``score(target, prediction)`` ->
    {type: Score}."""

    def __init__(self, rouge_types, use_stemmer: bool = False):
        unknown = set(rouge_types) - {"rouge1", "rougeL"}
        if unknown:
            raise ValueError(f"rouge types {sorted(unknown)}: only rouge1 and rougeL are kept")
        self.rouge_types = list(rouge_types)
        self._stemmer = PorterStemmer() if use_stemmer else None

    def score(self, target: str, prediction: str) -> dict:
        t, p = tokenize(target, self._stemmer), tokenize(prediction, self._stemmer)
        return {kind: _score_lcs(t, p) if kind == "rougeL" else _score_unigrams(t, p)
                for kind in self.rouge_types}
