# Copied from larynx_tpu/text/g2p/es.py; only the package name in its imports differs.
"""Spanish (Castilian) G2P — rule-based; Spanish orthography is phonemic.

Inventory (local/es-es/*/phonemes.txt): a ai au b d e ei eu f g i ja je jo
ju k l m n o oi ou p r s t t͡ʃ u wa we wi wo x ɲ ɾ ʎ ʝ θ + ˈ ˌ.
Diphthongs are single symbols.

NO stress marks are emitted: the released es-es voices' golden fixtures
show gruut produced zero stress ids across every sentence (cerveza,
despacio, favor, ... all unmarked in karen_savage test_phonemes.csv),
so the models were trained without them.  Written accents still shape
segment choice (diphthong breaking in "día", glide keeping in "adiós").
"""

import typing

from larynx_tpu_torch.text.g2p.rules import (
    apply_rules,
    apply_rules_span,
    spell_letters,
)

VOWELS = {
    "a", "e", "i", "o", "u",
    "ai", "au", "ei", "eu", "oi", "ou",
    "ja", "je", "jo", "ju", "wa", "we", "wi", "wo",
}

_ACCENTED = {"á": "a", "é": "e", "í": "i", "ó": "o", "ú": "u"}

_RULES = [
    # digraphs / context-free multigraphs
    ("ch", "t͡ʃ"),
    ("ll", "ʎ"),
    ("rr", "r"),
    ("qu", "k"),
    ("gü", "g w"),  # güe -> g w e
    # diphthongs (rising -> glide symbols, falling -> unit symbols)
    ("ai", "ai"), ("au", "au"),
    ("ei", "ei"), ("eu", "eu"),
    ("oi", "oi"), ("ou", "ou"),
    ("ia", "ja"), ("ie", "je"), ("io", "jo"), ("iu", "ju"),
    ("ua", "wa"), ("ue", "we"), ("ui", "wi"), ("uo", "wo"),
    ("uy", "wi"),
    # single letters
    ("a", "a"), ("b", "b"), ("d", "d"), ("e", "e"), ("f", "f"),
    ("h", ""),  # silent
    ("i", "i"), ("j", "x"), ("k", "k"), ("l", "l"), ("m", "m"),
    ("n", "n"), ("ñ", "ɲ"), ("o", "o"), ("p", "p"), ("r", "ɾ"),
    ("s", "s"), ("t", "t"), ("u", "u"), ("v", "b"), ("w", "w"),
    ("x", "k s"), ("y", "ʝ"), ("z", "θ"),
]


def _context(word: str, i: int):
    ch = word[i]
    nxt = word[i + 1] if i + 1 < len(word) else ""
    # word-initial Greek/Latin clusters reduce (psicología [s],
    # gnomo [n], mnemotécnica [n]) — RAE pronunciation
    if i == 0:
        for cluster, sound in (("ps", "s"), ("gn", "n"), ("mn", "n")):
            if word.startswith(cluster) and len(word) > 3:
                return 2, [sound]
    if word.startswith("ch", i):
        return 2, ["t͡ʃ"]
    # ay/ey/oy are diphthongs word-finally only (hoy); intervocalic y
    # is the consonant (mayo -> m a ʝ o)
    if ch in "aeo" and nxt == "y":
        if i + 2 == len(word):
            return 2, [{"a": "ai", "e": "ei", "o": "oi"}[ch]]
        return 1, [ch]
    if ch == "c":
        if nxt in ("e", "i", "é", "í"):
            return 1, ["θ"]
        return 1, ["k"]
    if ch == "g":
        if nxt in ("e", "i", "é", "í"):
            return 1, ["x"]
        if nxt == "ü":
            # güe/güi: u pronounced as glide — the inventory carries
            # glide+vowel unit symbols (we, wi), never bare w
            v = word[i + 2] if i + 2 < len(word) else ""
            if v in ("a", "e", "i", "o"):
                return 3, ["g", f"w{v}"]
            return 2, ["g", "u"]
        if word.startswith("gue", i) or word.startswith("gui", i):
            return 2, ["g"]  # silent u
        return 1, ["g"]
    if ch == "r" and i == 0:
        return 1, ["r"]  # initial r is trilled
    # r after n/l/s is also trilled (enrique, alrededor, israel)
    if ch == "r" and i > 0 and word[i - 1] in "nls":
        return 1, ["r"]
    if ch == "y" and i == len(word) - 1:
        return 1, ["i"]  # final y is vocalic ("hoy" handled by oy rule)
    # w (loanwords like "kiwi", "web"): glide+vowel unit symbols
    if ch == "w":
        if nxt in ("a", "e", "i", "o"):
            return 2, [f"w{nxt}"]
        return 1, ["u"]
    return None


# Spanish letter names (spell-out and ALL-CAPS initialisms)
_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "a": ["a"], "b": ["b", "e"], "c": ["θ", "e"], "d": ["d", "e"],
    "e": ["e"], "f": ["e", "f", "e"], "g": ["x", "e"],
    "h": ["a", "t͡ʃ", "e"], "i": ["i"], "j": ["x", "o", "t", "a"],
    "k": ["k", "a"], "l": ["e", "l", "e"], "m": ["e", "m", "e"],
    "n": ["e", "n", "e"], "ñ": ["e", "ɲ", "e"], "o": ["o"],
    "p": ["p", "e"], "q": ["k", "u"], "r": ["e", "r", "e"],
    "s": ["e", "s", "e"], "t": ["t", "e"], "u": ["u"],
    "v": ["u", "b", "e"], "w": ["u", "b", "e", "d", "o", "b", "l", "e"],
    "x": ["e", "k", "i", "s"], "y": ["i", "ɡ", "ɾ", "je", "ɡ", "a"],
    "z": ["θ", "e", "t", "a"],
}

# words seen fully capitalized for emphasis — never spell
_CAPS_WORDS = frozenset("""
el la los las un una y o de a en es son con por para que no si mi tu
su al del hay fue onu otan
""".split())


# x = [x] in Mexican place names kept with historic spelling
_EXCEPTIONS: typing.Dict[str, typing.Tuple[str, ...]] = {
    "méxico": ("m", "e", "x", "i", "k", "o"),
    "mexico": ("m", "e", "x", "i", "k", "o"),
    "mexicano": ("m", "e", "x", "i", "k", "a", "n", "o"),
    "mexicana": ("m", "e", "x", "i", "k", "a", "n", "a"),
    "texas": ("t", "e", "x", "a", "s"),
    "oaxaca": ("wa", "x", "a", "k", "a"),
    # loanwords
    "whisky": ("g", "wi", "s", "k", "i"),
    "güisqui": ("g", "wi", "s", "k", "i"),
    # gü + accented í: the accent-split would double the i
    "lingüística": ("l", "i", "n", "g", "wi", "s", "t", "i", "k", "a"),
    "lingüístico": ("l", "i", "n", "g", "wi", "s", "t", "i", "k", "o"),
    # English tech loans
    "email": ("i", "m", "ei", "l"),
    "software": ("s", "o", "f", "t", "we", "ɾ"),
    "google": ("g", "u", "g", "e", "l"),
    "youtube": ("ʝ", "u", "t", "u", "b"),
    "smartphone": ("e", "s", "m", "a", "ɾ", "f", "o", "n"),
    "online": ("o", "n", "l", "ai", "n"),
    # sub+rayar prefix seam keeps the trill
    "subrayar": ("s", "u", "b", "r", "a", "ʝ", "a", "ɾ"),
    "subrayado": ("s", "u", "b", "r", "a", "ʝ", "a", "d", "o"),
}


def phonemize(word: str) -> typing.List[str]:
    w = word.lower().strip()
    if not w:
        return []

    hit = _EXCEPTIONS.get(w)
    if hit is not None:
        return list(hit)

    # ALL-CAPS initialisms spell their letters (ONG, DNI, EEUU)
    if (
        word.isupper()
        and word.isalpha()
        and 2 <= len(word) <= 6
        and w not in _CAPS_WORDS
    ):
        return spell_letters(w, _LETTER_NAMES)
    if len(w) == 1 and w.isalpha() and w not in ("a", "e", "o", "u", "y"):
        return spell_letters(w, _LETTER_NAMES)

    # explicit accent marks the stressed vowel
    accent_pos = next((i for i, c in enumerate(w) if c in _ACCENTED), None)
    plain = "".join(_ACCENTED.get(c, c) for c in w)

    if accent_pos is not None:
        # phonemize in two halves so we know which symbol carries stress.
        # Two orthographic subtleties at the split point: an accented i/u
        # BREAKS a would-be diphthong (di-a in "día"), while an accented
        # strong vowel after i/u keeps the glide ("adiós" -> d jo).
        split = accent_pos
        head: typing.List[str] = []
        if w[accent_pos] in "íú":
            head = [plain[accent_pos]]
            split_end = accent_pos + 1
        elif (
            accent_pos > 0
            and plain[accent_pos - 1] in "iu"
            and plain[accent_pos] in "aeo"
            # the u of qué/aquél/llegué is the silent digraph u, not a
            # glide: let the else branch split at the accent so the
            # before-span keeps the qu/gu digraph intact
            and not (
                plain[accent_pos - 1] == "u"
                and plain[accent_pos] == "e"
                and accent_pos >= 2
                and plain[accent_pos - 2] in "qg"
            )
        ):
            glide = "j" if plain[accent_pos - 1] == "i" else "w"
            head = [glide + plain[accent_pos]]
            split = accent_pos - 1
            split_end = accent_pos + 1
            if (
                plain[accent_pos - 1] == "u"
                and accent_pos >= 2
                and plain[accent_pos - 2] == "q"
            ):
                # quó/quá (quórum, quásar): [kw] — a bare q carries no
                # rule, so consume it into the head
                head = ["k"] + head
                split = accent_pos - 2
        else:
            split_end = accent_pos
        # both halves walk the FULL word so boundary context survives
        # (policía: the c sees the following i; miércoles: the r after
        # the split is not word-initial)
        before = apply_rules_span(plain, 0, split, _RULES, _context)
        rest = head + apply_rules_span(
            plain, split_end, len(plain), _RULES, _context
        )
        return before + rest

    return apply_rules(plain, _RULES, _context)
