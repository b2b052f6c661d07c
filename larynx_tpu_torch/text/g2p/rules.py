# Copied from larynx_tpu/text/g2p/rules.py; only the package name in its imports differs.
"""Shared machinery for ordered-rule grapheme-to-phoneme engines."""

import typing

Rule = typing.Tuple[str, str]  # (grapheme pattern, space-separated phonemes)


def apply_rules(
    word: str,
    rules: typing.Sequence[Rule],
    context_rules: typing.Optional[
        typing.Callable[[str, int], typing.Optional[typing.Tuple[int, typing.List[str]]]]
    ] = None,
) -> typing.List[str]:
    """Greedy longest-match left-to-right rule application.

    ``context_rules(word, i)`` may claim a span first: return
    (consumed_length, phonemes) or None.
    """
    return apply_rules_span(word, 0, len(word), rules, context_rules)


def stress_nth_vowel_from_end(
    phonemes: typing.List[str],
    vowels: typing.Container[str],
    n: int = 2,
    marker: str = "ˈ",
    skippable: typing.Container[str] = (),
    exclude_positions: typing.Container[int] = (),
) -> typing.List[str]:
    """Attach a stress marker to the n-th vowel symbol from the end
    (n=2 ~ penultimate syllable, n=1 ~ final); no-op if already stressed.

    ``skippable`` vowels (e.g. Dutch schwa) are never stressed and do not
    count toward n — "langzamer" (ɑ aː ə) stresses ɑ with n=2, skippable
    ə: the schwa syllable is invisible to the count.  If every vowel is
    skippable, the plain count applies.  ``exclude_positions`` removes
    specific indices from the count (e.g. the u of an Italian falling
    au-diphthong, which is a vowel symbol but not a syllable nucleus).
    """
    if any(p.startswith(("ˈ", "ˌ", "'")) for p in phonemes):
        return phonemes
    vowel_positions = [
        i
        for i, p in enumerate(phonemes)
        if p in vowels and i not in exclude_positions
    ]
    if not vowel_positions:
        return phonemes
    countable = [i for i in vowel_positions if phonemes[i] not in skippable]
    positions = countable or vowel_positions
    idx = positions[-n] if len(positions) >= n else positions[0]
    out = list(phonemes)
    out[idx] = marker + out[idx]
    return out


_NASALS = frozenset({"m", "n", "ŋ", "ɱ", "ɲ"})
_GLIDES = frozenset({"j", "w"})
_LIQUIDS_GLIDES = frozenset({"r", "l", "ɹ", "j", "w", "ʎ"})
_S_LIKE = frozenset({"s", "z", "ʃ", "ʒ", "x"})


def shift_stress_to_onset(
    phonemes: typing.List[str],
    vowels: typing.Container[str],
) -> typing.List[str]:
    """Convert vowel-attached stress (p a r l ˈa r e) to a standalone
    marker before the syllable onset (p a r ˈ l a r e).

    gruut emits the stress id at the START of the stressed syllable for
    it-it and nl (decoded from the released voices' test_phonemes.csv:
    "italiano" -> i t a ˈ l j a n o, "presentje" -> ˈ p ɹ ɛ ...), so the
    id sequence the voices were trained on has the mark before the onset
    consonants, not the vowel.

    Onset = longest preceding consonant cluster that could begin a word:
    a single consonant; obstruent + liquid (b+l, t+r); any consonant +
    glide (v+j, l+j: "italiano" -> i t a ˈ l j a n o); s-like + anything
    (s+t, s+m, impure s).  A geminate splits — the left copy stays in
    the coda (città -> t͡ʃ i t ˈ t a) — and nasal + obstruent splits,
    the nasal staying in the coda ("pensare" -> p e n ˈ s a r e).
    """
    out: typing.List[str] = []
    for p in phonemes:
        mark = ""
        while p and p[0] in ("ˈ", "ˌ"):
            mark += p[0]
            p = p[1:]
        if not mark or not p:
            out.append(mark + p if p else mark)
            continue
        # walk back over out[] to find the onset start
        onset_start = len(out)
        while onset_start > 0:
            c = out[onset_start - 1]
            if c in vowels or c in ("ˈ", "ˌ") or c.startswith(("ˈ", "ˌ")):
                break
            cluster_len = len(out) - (onset_start - 1)
            if onset_start == len(out):
                pass  # first consonant always joins
            else:
                head = out[onset_start]
                if c == head:
                    break  # geminate: left copy is coda
                if cluster_len > 3:
                    break
                if c in _S_LIKE:
                    pass  # impure s / s+C cluster (st, sm, sx/sch...)
                elif head in _GLIDES and c not in _GLIDES:
                    pass  # any consonant + glide (vj, lj, kw, nj)
                elif (
                    head in _LIQUIDS_GLIDES
                    and c not in _LIQUIDS_GLIDES
                    and c not in _NASALS
                ):
                    pass  # obstruent + liquid
                else:
                    break
            onset_start -= 1
        out.insert(onset_start, mark)
        out.append(p)
    return out


def spell_letters(
    w: str, letter_names: typing.Mapping[str, typing.List[str]]
) -> typing.List[str]:
    """Concatenate per-letter name pronunciations (initialisms/spell-out)."""
    out: typing.List[str] = []
    for ch in w:
        out.extend(letter_names.get(ch, []))
    return out


def acronym_readable(w: str, vowels: str = "aeiou") -> bool:
    """Heuristic: an ALL-CAPS token reads as a word (NASA, NATO) rather
    than spelling letters when every <=3-letter window has a vowel and
    it does not end in a 2+-consonant coda."""
    if not any(c in vowels for c in w):
        return False
    run = 0
    for c in w:
        run = 0 if c in vowels else run + 1
        if run >= 3:
            return False
    return w[-1] in vowels or w[-2] in vowels


def apply_rules_span(
    word: str,
    start: int,
    stop: int,
    rules: typing.Sequence[Rule],
    context_rules=None,
) -> typing.List[str]:
    """apply_rules over word[start:stop] with context drawn from the FULL
    word.  Accent handling splits words at the stressed vowel; the halves
    must not look like word edges (Spanish "policía" needs the c to see
    its i; Italian "già" needs gi+à to read as one unit).  A context rule
    may consume past ``stop`` (marker letters merging with the stressed
    vowel); plain rules are clipped to the span."""
    out: typing.List[str] = []
    i = start
    while i < stop:
        if context_rules is not None:
            claimed = context_rules(word, i)
            if claimed is not None:
                length, phones = claimed
                out.extend(phones)
                i += length
                continue
        for pattern, phones in rules:
            if word.startswith(pattern, i) and i + len(pattern) <= stop:
                if phones:
                    out.extend(phones.split())
                i += len(pattern)
                break
        else:
            i += 1
    return out
