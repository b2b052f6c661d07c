# Copied from larynx_tpu/text/g2p/nl.py; only the package name in its imports differs.
"""Dutch G2P — rule-based.

Inventory (local/nl/*/phonemes.txt): a aː b c d e eː f h i iː j k l m n o
oː p s t u uː v w x y yː z ø ŋ œy œː ɑ ɑu ɑː ɔ ɔː ə ɛ ɛi ɛː ɡ ɣ ɪ ʏ ʏː ɹ
ʃ ʒ ʔ ɱ + ˈ ˌ.
"""

import typing

from larynx_tpu_torch.text.g2p.rules import (
    apply_rules,
    shift_stress_to_onset,
    spell_letters,
    stress_nth_vowel_from_end,
)

VOWELS = {
    "a", "aː", "e", "eː", "i", "iː", "o", "oː", "u", "uː", "y", "yː",
    "ø", "œy", "œː", "ɑ", "ɑu", "ɑː", "ɔ", "ɔː", "ə", "ɛ", "ɛi", "ɛː",
    "ɪ", "ʏ", "ʏː",
}

_RULES = [
    ("zesen", "z ɛ s ə n"),  # number linker: zesentwintig [zɛsən-]
    ("sch", "s x"),
    ("ch", "x"),
    ("ng", "ŋ"),
    ("ij", "ɛi"), ("ei", "ɛi"),
    ("ui", "œy"),
    ("ou", "ɑu"), ("au", "ɑu"),
    ("oe", "u"),
    ("ieuw", "i w"), ("eeuw", "eː w"),  # before ee/ie (first match wins)
    ("eau", "oː"),  # French loans: cadeau, bureau, niveau
    ("eu", "ø"),
    ("aa", "aː"), ("ee", "eː"), ("oo", "oː"), ("uu", "yː"),
    ("ie", "i"),
    ("éé", "eː"), ("é", "eː"), ("è", "ɛ"), ("ë", "ɛ"), ("ï", "i"),
    ("th", "t"),
    ("a", "ɑ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"),
    ("f", "f"), ("g", "ɣ"), ("h", "h"), ("i", "ɪ"), ("j", "j"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "ɔ"),
    ("p", "p"), ("q", "k"), ("r", "ɹ"), ("s", "s"), ("t", "t"),
    ("u", "ʏ"), ("v", "v"), ("w", "w"), ("x", "k s"), ("y", "j"),
    ("z", "z"),
]

_OPEN_LONG = {"a": "aː", "e": "eː", "o": "oː", "u": "yː", "i": "i"}


_DOUBLE_MAP = {
    "b": "b", "d": "d", "f": "f", "g": "ɣ", "k": "k", "l": "l",
    "m": "m", "n": "n", "p": "p", "r": "ɹ", "s": "s", "t": "t",
}

_VOWEL_LETTERS = "aeiou"


def _n_vowel_letters(word: str) -> int:
    return sum(c in _VOWEL_LETTERS + "éèëï" for c in word)


def _context(word: str, i: int):
    ch = word[i]
    nxt = word[i + 1] if i + 1 < len(word) else ""
    nxt2 = word[i + 2] if i + 2 < len(word) else ""
    prev = word[i - 1] if i > 0 else ""
    # doubled consonants are single sounds
    if nxt == ch and ch in _DOUBLE_MAP:
        return 2, [_DOUBLE_MAP[ch]]
    # c softens before front vowels (december, cijfer)
    if ch == "c" and nxt and nxt in "ei":
        return 1, ["s"]
    # i between vowels is a glide (groeien, draaien)
    if ch == "i" and prev and prev in _VOWEL_LETTERS and nxt == "e":
        return 1, ["j"]
    # unstressed e in a NON-final syllable before n/r + consonant:
    # compound linkers and suffixes (ziekenhuis, wetenschap, zaterdag,
    # bakkerij) — the word must go on with more vowels, so the stressed
    # -ent/-ens finals (president) stay full
    if (
        ch == "e"
        and nxt in "nr"
        and nxt2 and nxt2 not in _VOWEL_LETTERS
        and _n_vowel_letters(word[:i]) >= 1
        and _n_vowel_letters(word[i + 2 :]) >= 1
    ):
        return 2, ["ə", {"r": "ɹ"}.get(nxt, nxt)]
    # the -erij suffix is [ə ɹ ɛi] (bakkerij)
    if word.endswith("erij") and i == len(word) - 4:
        return 4, ["ə", "ɹ", "ɛi"]
    # final single o is long and open (radio, kilo)
    if ch == "o" and i + 1 == len(word) and len(word) > 1:
        return 1, ["oː"]
    # unstressed e in final syllables of polysyllables: -e/-en/-el/... ;
    # -er(d/s/en) vocalizes to ə + ɹ
    if ch == "n" and nxt == "k":
        return 1, ["ŋ"]
    if ch == "e" and (
        _n_vowel_letters(word[:i]) >= 1 or (i == 1 and word[i:] == "e")
    ):
        tail = word[i:]
        # unstressed -elijk(e/s) adjectives (hartelijk, vriendelijke);
        # -ellijk spellings share the stem-final l (onmiddellijk)
        for suf in ("ellijk", "elijk"):
            if tail.startswith(suf):
                rest = tail[len(suf):]
                if rest in ("", "e", "s", "er", "ers", "ste", "heid",
                            "heden"):
                    return len(suf), ["ə", "l", "ə", "k"]
        if tail in ("e", "en", "el", "em", "es", "et", "er", "erd",
                    "ers", "erg", "eren", "elen", "els", "ens", "enen",
                    "emen", "end", "ends"):
            out = ["ə"]
            for c in tail[1:]:
                out.append({"d": "t", "g": "x", "r": "ɹ", "e": "ə"}.get(c, c))
            return len(tail), out
    # open syllable: single vowel + single consonant + vowel => long
    if (
        ch in _OPEN_LONG
        and nxt and nxt not in _VOWEL_LETTERS
        and nxt2 and nxt2 in _VOWEL_LETTERS + "éèëï"
        and nxt != nxt2
    ):
        return 1, [_OPEN_LONG[ch]]
    # i after a vowel closes a diphthong (mooi, nooit, draai)
    if ch == "i" and prev and prev in _VOWEL_LETTERS and (
        nxt == "" or nxt not in _VOWEL_LETTERS
    ):
        return 1, ["j"]
    # unstressed -lijk(e) after a consonant (moeilijk via exception,
    # schriftelijk via the elijk tail above, mogelijk -> moːɣələk)
    if word.startswith("lijk", i) and i > 0 and word[i + 4 :] in (
        "", "e", "s", "er", "ers", "ste", "heid", "heden"
    ):
        return 4, ["l", "ə", "k"]
    # verb-final -dt is a single [t] (houdt, wordt)
    if ch == "d" and nxt == "t" and i + 2 == len(word):
        return 2, ["t"]
    # obstruents devoice before voiceless s/t inside a cluster
    # (gezegd [xt], hoogst [xst], oudste [tst], raadsel [tsəl])
    if ch == "g" and nxt and nxt in "st":
        return 1, ["x"]
    if ch == "d" and nxt == "s":
        return 1, ["t"]
    # participle-final -gd is fully devoiced (gezegd, gevraagd [xt])
    if ch == "g" and nxt == "d" and i + 2 == len(word):
        return 2, ["x", "t"]
    # plural of -ee stems: the trema vowel is schwa (zeeën, ideeën)
    if ch == "ë" and nxt == "n" and i + 2 == len(word):
        return 2, ["ə", "n"]
    # loan-final y after a consonant is [i] (hobby, baby, pony)
    if ch == "y" and i + 1 == len(word) and prev and prev not in _VOWEL_LETTERS:
        return 1, ["i"]
    # diminutive -etje(s) is fully reduced (jongetje [jɔŋətjə])
    if (
        ch == "e"
        and word.startswith("etje", i)
        and word[i + 4 :] in ("", "s")
        and i > 0
    ):
        return 4, ["ə", "t", "j", "ə"]
    # final devoicing (b/d/v stops+fricative, g -> x)
    if i + 1 == len(word):
        if ch in "bdv":
            return 1, [{"b": "p", "d": "t", "v": "f"}[ch]]
        if ch == "g":
            return 1, ["x"]
    return None


# Function words and loanwords the letter rules cannot see.
_EXCEPTIONS: typing.Dict[str, typing.Tuple[str, ...]] = {
    "een": ("ə", "n"),
    "het": ("h", "ɛ", "t"),
    "politie": ("p", "oː", "l", "i", "t", "s", "i"),
    "vakantie": ("v", "ɑ", "k", "ɑ", "n", "s", "i"),
    "thee": ("t", "eː"),
    "nieuws": ("n", "i", "w", "s"),
    "jullie": ("j", "ʏ", "l", "i"),
    "alleen": ("ɑ", "l", "eː", "n"),
    "hallo": ("h", "ɑ", "l", "oː"),
    "auto": ("ɑu", "t", "oː"),
    "zo": ("z", "oː"),
    "na": ("n", "aː"),
    "ja": ("j", "aː"),
    "nu": ("n", "yː"),
    "u": ("yː",),
    "wereld": ("w", "eː", "ɹ", "ə", "l", "t"),
    "avond": ("aː", "v", "ɔ", "n", "t"),
    "duizend": ("d", "œy", "z", "ə", "n", "t"),
    "arbeid": ("ɑ", "ɹ", "b", "ɛi", "t"),
    "vriendelijk": ("v", "ɹ", "i", "n", "d", "ə", "l", "ə", "k"),
    "moeilijk": ("m", "u", "j", "l", "ə", "k"),
    "onmiddellijk": ("ɔ", "n", "ˈ", "m", "ɪ", "d", "ə", "l", "ə", "k"),
    "eigenlijk": ("ɛi", "ɣ", "ə", "l", "ə", "k"),
    "natuurlijk": ("n", "ɑ", "t", "yː", "ɹ", "l", "ə", "k"),
    "geschiedenis": ("ɣ", "ə", "s", "x", "i", "d", "ə", "n", "ɪ", "s"),
    "regering": ("ɹ", "ə", "ɣ", "eː", "ɹ", "ɪ", "ŋ"),
    "meneer": ("m", "ə", "n", "eː", "ɹ"),
    "helemaal": ("h", "eː", "l", "ə", "m", "aː", "l"),
    "ontwikkeling": ("ɔ", "n", "t", "w", "ɪ", "k", "ə", "l", "ɪ", "ŋ"),
    # French loans keep final stress (pre-stressed: the penult default
    # must not fire)
    "celsius": ("s", "ˈɛ", "l", "s", "i", "ʏ", "s"),
    "economie": ("eː", "k", "oː", "n", "oː", "m", "ˈi"),
    "misschien": ("m", "ɪ", "s", "x", "ˈi", "n"),
    "geleden": ("ɣ", "ə", "l", "eː", "d", "ə", "n"),
    "genoeg": ("ɣ", "ə", "n", "u", "x"),
    "gelukkig": ("ɣ", "ə", "l", "ʏ", "k", "ə", "x"),
    "gezicht": ("ɣ", "ə", "z", "ɪ", "x", "t"),
    "bedankt": ("b", "ə", "d", "ɑ", "ŋ", "k", "t"),
    "miljoen": ("m", "ɪ", "l", "j", "u", "n"),
    "miljard": ("m", "ɪ", "l", "j", "ɑ", "ɹ", "t"),
    "universiteit": ("yː", "n", "i", "v", "ɛ", "ɹ", "s", "i", "t", "ˈɛi", "t"),
    "luchthaven": ("l", "ʏ", "x", "t", "h", "aː", "v", "ə", "n"),
    # loanword / compound stress the penult default cannot know
    # (pre-stressed entries: stress_nth is a no-op when a mark exists)
    "station": ("s", "t", "ɑ", "ʃ", "ˈɔ", "n"),
    # French loans with [ʒ]/[ʃ] the letter rules cannot see
    "horloge": ("h", "ɔ", "ɹ", "l", "ˈoː", "ʒ", "ə"),
    "garage": ("ɣ", "ɑ", "ɹ", "ˈaː", "ʒ", "ə"),
    "etage": ("eː", "t", "ˈaː", "ʒ", "ə"),
    "bagage": ("b", "ɑ", "ɣ", "ˈaː", "ʒ", "ə"),
    "massage": ("m", "ɑ", "s", "ˈaː", "ʒ", "ə"),
    "stage": ("s", "t", "ˈaː", "ʒ", "ə"),
    "percentage": ("p", "ɛ", "ɹ", "s", "ɛ", "n", "t", "ˈaː", "ʒ", "ə"),
    "college": ("k", "ɔ", "l", "ˈeː", "ʒ", "ə"),
    "restaurant": ("ɹ", "ɛ", "s", "t", "oː", "ɹ", "ˈɑ", "n", "t"),
    "journalist": ("ʒ", "u", "ɹ", "n", "aː", "l", "ˈɪ", "s", "t"),
    "journaal": ("ʒ", "u", "ɹ", "n", "ˈaː", "l"),
    "jury": ("ʒ", "ˈyː", "ɹ", "i"),
    "chocolade": ("ʃ", "oː", "k", "oː", "l", "ˈaː", "d", "ə"),
    "chocola": ("ʃ", "oː", "k", "oː", "l", "ˈaː"),
    # other loans / silent letters
    "baby": ("b", "ˈeː", "b", "i"),
    "pizza": ("p", "ˈi", "t", "s", "ɑ"),
    "weekend": ("w", "ˈi", "k", "ɛ", "n", "t"),
    "cowboy": ("k", "ˈɑu", "b", "ɔ", "j"),
    "cacao": ("k", "ɑ", "k", "ˈɑu"),
    "erwt": ("ɛ", "ɹ", "t"),
    "erwten": ("ɛ", "ɹ", "t", "ə", "n"),
    "bijzonder": ("b", "i", "z", "ˈɔ", "n", "d", "ə", "ɹ"),
    "taxi": ("t", "ˈɑ", "k", "s", "i"),
    "pony": ("p", "ˈoː", "n", "i"),
    "banaan": ("b", "ɑ", "n", "ˈaː", "n"),
    "officieel": ("ɔ", "f", "i", "ʃ", "ˈeː", "l"),
    "officiële": ("ɔ", "f", "i", "ʃ", "ˈeː", "l", "ə"),
    "financieel": ("f", "i", "n", "ɑ", "n", "ʃ", "ˈeː", "l"),
    "financiële": ("f", "i", "n", "ɑ", "n", "ʃ", "ˈeː", "l", "ə"),
    "olifant": ("ˈoː", "l", "i", "f", "ɑ", "n", "t"),
    # place names / proper nouns
    "belgië": ("b", "ˈɛ", "l", "ɣ", "i", "j", "ə"),
    "engeland": ("ˈɛ", "ŋ", "ə", "l", "ɑ", "n", "t"),
    "johannes": ("j", "oː", "h", "ˈɑ", "n", "ə", "s"),
    # English tech loans
    "email": ("ˈi", "m", "eː", "l"),
    "e-mail": ("ˈi", "m", "eː", "l"),
    "website": ("w", "ˈɛ", "p", "s", "ɑ", "j", "t"),
    "online": ("ɔ", "n", "l", "ˈɑ", "j", "n"),
    "software": ("s", "ˈɔ", "f", "t", "w", "ɛː", "ɹ"),
    "smartphone": ("s", "m", "ˈɑ", "ɹ", "t", "f", "oː", "n"),
    "google": ("ɡ", "ˈu", "ɡ", "ə", "l"),
    "youtube": ("j", "ˈu", "t", "j", "u", "p"),
    "wifi": ("w", "ˈi", "f", "i"),
    "downloaden": ("d", "ˈɑu", "n", "l", "oː", "d", "ə", "n"),
    "procent": ("p", "ɹ", "oː", "s", "ˈɛ", "n", "t"),
    "amsterdam": ("ɑ", "m", "s", "t", "ə", "ɹ", "d", "ˈɑ", "m"),
    "rotterdam": ("ɹ", "ɔ", "t", "ə", "ɹ", "d", "ˈɑ", "m"),
    "bioscoop": ("b", "i", "ɔ", "s", "k", "ˈoː", "p"),
    "rivier": ("ɹ", "i", "v", "ˈi", "ɹ"),
    "mevrouw": ("m", "ə", "v", "ɹ", "ˈɑu"),
    "hoeveel": ("h", "u", "v", "ˈeː", "l"),
    "vanavond": ("v", "ɑ", "n", "ˈaː", "v", "ɔ", "n", "t"),
    "vanochtend": ("v", "ɑ", "n", "ˈɔ", "x", "t", "ə", "n", "t"),
    "vanmiddag": ("v", "ɑ", "n", "m", "ˈɪ", "d", "ɑ", "x"),
    "vanmorgen": ("v", "ɑ", "n", "m", "ˈɔ", "ɹ", "ɣ", "ə", "n"),
    "vannacht": ("v", "ɑ", "n", "n", "ˈɑ", "x", "t"),
    "avondeten": ("ˈaː", "v", "ɔ", "n", "t", "eː", "t", "ə", "n"),
    "goedemorgen": ("ɣ", "ˈu", "d", "ə", "m", "ɔ", "ɹ", "ɣ", "ə", "n"),
    "goedemiddag": ("ɣ", "ˈu", "d", "ə", "m", "ɪ", "d", "ɑ", "x"),
    "goedenavond": ("ɣ", "ˈu", "d", "ə", "n", "aː", "v", "ɔ", "n", "t"),
    "goedenacht": ("ɣ", "ˈu", "d", "ə", "n", "ɑ", "x", "t"),
    "lerares": ("l", "eː", "ɹ", "aː", "ɹ", "ˈɛ", "s"),
    "studeert": ("s", "t", "yː", "d", "ˈeː", "ɹ", "t"),
    "studeren": ("s", "t", "yː", "d", "ˈeː", "ɹ", "ə", "n"),
    "student": ("s", "t", "yː", "d", "ˈɛ", "n", "t"),
    "studenten": ("s", "t", "yː", "d", "ˈɛ", "n", "t", "ə", "n"),
    "platteland": ("p", "l", "ˈɑ", "t", "ə", "l", "ɑ", "n", "t"),
    "telefoon": ("t", "eː", "l", "ə", "f", "ˈoː", "n"),
    "computer": ("k", "ɔ", "m", "p", "j", "ˈuː", "t", "ə", "ɹ"),
    "alsjeblieft": ("ɑ", "l", "s", "j", "ə", "b", "l", "ˈi", "f", "t"),
    "minuut": ("m", "i", "n", "ˈyː", "t"),
    "minuten": ("m", "i", "n", "ˈyː", "t", "ə", "n"),
    "museum": ("m", "y", "z", "ˈeː", "ʏ", "m"),
    "theater": ("t", "eː", "ˈaː", "t", "ə", "ɹ"),
    "concert": ("k", "ɔ", "n", "s", "ˈɛ", "ɹ", "t"),
    "interessant": ("ɪ", "n", "t", "ə", "ɹ", "ɛ", "s", "ˈɑ", "n", "t"),
    "muziek": ("m", "yː", "z", "ˈi", "k"),
    "persoon": ("p", "ɛ", "ɹ", "s", "ˈoː", "n"),
    "personen": ("p", "ɛ", "ɹ", "s", "ˈoː", "n", "ə", "n"),
    "medicijn": ("m", "eː", "d", "i", "s", "ˈɛi", "n"),
    "dictee": ("d", "ɪ", "k", "t", "ˈeː"),
    "examen": ("ɛ", "k", "s", "ˈaː", "m", "ə", "n"),
    "bibliotheek": ("b", "i", "b", "l", "i", "oː", "t", "ˈeː", "k"),
    "fabriek": ("f", "ɑ", "b", "ɹ", "ˈi", "k"),
    "auto's": ("ˈɑu", "t", "oː", "s"),
    "ingenieur": ("ɪ", "n", "ʒ", "ə", "n", "j", "ˈø", "ɹ"),
    "controleert": ("k", "ɔ", "n", "t", "ɹ", "oː", "l", "ˈeː", "ɹ", "t"),
    "controleren": ("k", "ɔ", "n", "t", "ɹ", "oː", "l", "ˈeː", "ɹ", "ə", "n"),
    "machine": ("m", "ɑ", "ʃ", "ˈi", "n", "ə"),
    "machines": ("m", "ɑ", "ʃ", "ˈi", "n", "ə", "s"),
    "moeilijke": ("m", "ˈu", "j", "l", "ə", "k", "ə"),
    "voorbij": ("v", "oː", "ɹ", "b", "ˈɛi"),
    "sneeuw": ("s", "n", "ˈeː", "w"),
    "sneeuwt": ("s", "n", "ˈeː", "w", "t"),
}

# Unstressed prefixes: the stem keeps the word stress (begrijp ->
# [bəˈɣrɛip]; fixture: "gefeliciteerd" -> ɣ ə ˌf e..., "verjaardag" ->
# v ə ɹ ˈj a ɹ d ɑ x).
_PREFIXES = (("ge", ["ɣ", "ə"]), ("be", ["b", "ə"]), ("ver", ["v", "ə", "ɹ"]))

# Stem-initial ge/be/ver words the prefix heuristic must skip.
_NOT_PREFIXED = frozenset({
    "geven", "geeft", "gele", "gevel", "gevels", "genen", "gene",
    "beter", "betere", "beters", "bezem", "bever", "bevers", "beker",
    "bekers", "benen", "bezig",
    "verder", "verdere", "verte", "verven", "verse", "versie",
    "verzen", "veren",
})

_VALID_ONSET_2 = frozenset({
    "bl", "br", "dr", "dw", "fl", "fr", "gl", "gr", "kl", "kn", "kr",
    "kw", "pl", "pr", "sl", "sm", "sn", "sp", "st", "sx", "tr", "tw",
    "vl", "vr", "zw", "sc", "ch",
})


def _valid_stem_start(rest: str) -> bool:
    if rest[0] in _VOWEL_LETTERS:
        return False
    if len(rest) >= 2 and rest[1] in _VOWEL_LETTERS + "éij":
        return True
    return rest.startswith("sch") or rest[:2] in _VALID_ONSET_2


# Separable-particle participles: <particle>ge<stem> with primary
# stress on the particle (fixture: "toegewenst" -> ˈtu ɣə ˌwɛnst).
_SEP_GE_PREFIXES = {
    "afge": ["ˈɑ", "f", "ɣ", "ə"],
    "opge": ["ˈɔ", "p", "ɣ", "ə"],
    "uitge": ["ˈœy", "t", "ɣ", "ə"],
    "aange": ["ˈaː", "n", "ɣ", "ə"],
    "inge": ["ˈɪ", "n", "ɣ", "ə"],
    "toege": ["t", "ˈu", "ɣ", "ə"],
    "meege": ["m", "ˈeː", "ɣ", "ə"],
    "wegge": ["w", "ˈɛ", "x", "ɣ", "ə"],
}


def _phonemize_vowel_stress(word: str) -> typing.List[str]:
    w = word.lower().strip()
    if not w:
        return []
    # a written acute é marks the stressed (final) syllable in loanwords
    # (café, privé / idé, armé, kommitté) — override the penult default
    n = 1 if "é" in w else 2
    # Romance suffixes carry final stress (schilderij, natuur, toneel,
    # directeur, journalist, kwaliteit, miljoen, formulier, student,
    # diamant, banaan); native compound tails that share the spelling
    # are excluded (voordeel, haarkleur, zeemist-style -mist, the
    # baan/maan/laan/kraan/traan/zwaan roots, olifant)
    if n == 2 and len(w) > 4 and w.endswith(
        # -uur only in its Romance shapes -tuur/-guur (natuur, figuur);
        # bare -uur compounds keep the head stress (spreekuur, lesuur)
        ("ij", "tuur", "guur", "eel", "eur", "ist", "teit", "oen", "ier",
         "ent", "ant", "aan")
    ) and not w.endswith(
        ("deel", "deur", "kleur", "geur", "scheur", "sleur", "zeur",
         "fleur", "keur", "mist", "baan", "maan", "haan", "laan",
         "kraan", "traan", "vaan", "spaan", "zwaan", "olifant")
    ):
        n = 1
    hit = _EXCEPTIONS.get(w)
    if hit is not None:
        return stress_nth_vowel_from_end(list(hit), VOWELS, n=n, skippable=("ə",))
    if w not in _NOT_PREFIXED and len(w) > 4:
        for pre, sounds in _SEP_GE_PREFIXES.items():
            if w.startswith(pre) and len(w) > len(pre) + 2 and any(
                c in _VOWEL_LETTERS for c in w[len(pre):]
            ):
                stem = _phonemize_vowel_stress(w[len(pre):])
                # particle carries primary stress; the stem keeps
                # secondary (fixture: toegewenst -> ˈtu ɣə ˌwɛnst)
                stem = [p.replace("ˈ", "ˌ") if p.startswith("ˈ") else p
                        for p in stem]
                return list(sounds) + stem
        for pre, sounds in _PREFIXES:
            rest = w[len(pre):]
            if w.startswith(pre) and len(rest) >= 2 and any(
                c in _VOWEL_LETTERS for c in rest
            ) and _valid_stem_start(rest):
                return list(sounds) + _phonemize_vowel_stress(rest)
    phonemes = apply_rules(w, _RULES, _context)
    return stress_nth_vowel_from_end(phonemes, VOWELS, n=n, skippable=("ə",))


# Dutch letter names (spell-out / ALL-CAPS initialisms), unstressed
_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "a": ["aː"], "b": ["b", "eː"], "c": ["s", "eː"], "d": ["d", "eː"],
    "e": ["eː"], "f": ["ɛ", "f"], "g": ["ɣ", "eː"], "h": ["h", "aː"],
    "i": ["i"], "j": ["j", "eː"], "k": ["k", "aː"], "l": ["ɛ", "l"],
    "m": ["ɛ", "m"], "n": ["ɛ", "n"], "o": ["oː"], "p": ["p", "eː"],
    "q": ["k", "yː"], "r": ["ɛ", "ɹ"], "s": ["ɛ", "s"],
    "t": ["t", "eː"], "u": ["yː"], "v": ["v", "eː"], "w": ["w", "eː"],
    "x": ["ɪ", "k", "s"], "y": ["ɛi"], "z": ["z", "ɛ", "t"],
}


def phonemize(word: str) -> typing.List[str]:
    """Dutch word -> IPA with gruut's onset-position stress ids (the nl
    voices' test_phonemes.csv put ˈ before the syllable onset:
    "prettige" -> ˈ p ɹ ɛ t ə ɣ ə, "alstublieft" -> ˌ ɑ l s t y ˈ b l i f t).
    Schwa syllables never take stress and are invisible to the penult
    count ("langzamer" ɑ-a-ə stresses ɑ)."""
    if word.isalpha() and (
        (word.isupper() and 2 <= len(word) <= 6) or len(word) == 1
    ) and word.lower() not in _EXCEPTIONS and all(
        c in _LETTER_NAMES for c in word.lower()
    ):
        return spell_letters(word.lower(), _LETTER_NAMES)
    return shift_stress_to_onset(_phonemize_vowel_stress(word), VOWELS)
