# Copied from larynx_tpu/text/g2p/sw.py; only the package name in its imports differs.
"""Swahili G2P — rule-based; Swahili orthography is phonemic.

Inventory (local/sw/*/phonemes.txt): f h i j k l m n p s t t͡ʃ u v w x z ð
ɑ ɓ ɔ ɗ ɛ ɠ ɣ ɾ ʃ ʄ θ + prenasalized ᵐɓ ᵑg ᶬv ⁿz ⁿɗ ⁿɗ͡ʒ + ˈ ˌ.
Stress is penultimate.
"""

import typing

from larynx_tpu_torch.text.g2p.rules import apply_rules

VOWELS = {"ɑ", "ɛ", "i", "ɔ", "u"}

_RULES = [
    ("ng'", "ᵑg"),
    ("mb", "ᵐɓ"),
    ("mv", "ᶬv"),
    ("nd", "ⁿɗ"),
    ("nj", "ⁿɗ͡ʒ"),
    ("nz", "ⁿz"),
    ("ng", "ᵑg"),
    ("ch", "t͡ʃ"),
    ("dh", "ð"),
    ("gh", "ɣ"),
    ("kh", "x"),
    ("sh", "ʃ"),
    ("th", "θ"),
    ("ny", "n j"),
    ("a", "ɑ"), ("b", "ɓ"), ("d", "ɗ"), ("e", "ɛ"), ("f", "f"),
    ("g", "ɠ"), ("h", "h"), ("i", "i"), ("j", "ʄ"), ("k", "k"),
    ("l", "l"), ("m", "m"), ("n", "n"), ("o", "ɔ"), ("p", "p"),
    ("r", "ɾ"), ("s", "s"), ("t", "t"), ("u", "u"), ("v", "v"),
    ("w", "w"), ("x", "x"), ("y", "j"), ("z", "z"),
]


def phonemize(word: str) -> typing.List[str]:
    """Swahili word -> IPA with NO stress marks.

    The biblia_takatifu voice's golden fixtures show gruut-sw emitted
    no stress ids anywhere (nakutakia, unazungumza, kiswahili all
    unmarked) — the voice was trained without them, so the regular
    penult stress stays unwritten here too."""
    w = word.lower().strip()
    if not w:
        return []
    return apply_rules(w, _RULES)
