# Copied from larynx_tpu/text/g2p/de.py; only the package name in its imports differs.
"""German G2P — rule-based.

Inventory (local/de-de/*/phonemes.txt): a aɪ̯ aʊ̯ aː b d d͡ʒ eː f g h iː j k
l m n oː p p͡f s t t͡s t͡ʃ uː v x yː z ç ŋ œ ɐ ɔ ɔʏ̯ ə ɛ ɛː ɪ ʁ ʃ ʊ ʏ ʒ ʔ χ
(+ nasals ãː õː ɛ̃ː for loanwords); no stress markers.
"""

import typing

from larynx_tpu_torch.text.g2p.rules import (
    acronym_readable,
    apply_rules,
    spell_letters,
)

_BACK_VOWELS = "aouäöü"  # preceding vowel deciding ach- vs ich-Laut

_RULES = [
    ("tsch", "t͡ʃ"),
    ("dsch", "d͡ʒ"),
    ("sch", "ʃ"),
    ("chs", "k s"),
    ("ck", "k"),
    ("dt", "t"),
    ("ih", "iː"),
    ("ph", "f"),
    ("th", "t"),
    ("qu", "k v"),
    ("pf", "p͡f"),
    ("tz", "t͡s"),
    ("ei", "aɪ̯"), ("ai", "aɪ̯"), ("ey", "aɪ̯"), ("ay", "aɪ̯"),
    ("au", "aʊ̯"),
    ("eu", "ɔʏ̯"), ("äu", "ɔʏ̯"),
    ("ie", "iː"),
    ("aa", "aː"), ("ah", "aː"),
    ("ee", "eː"), ("eh", "eː"),
    ("oo", "oː"), ("oh", "oː"),
    ("uh", "uː"),
    ("äh", "ɛː"),
    ("öh", "øː"),
    ("üh", "yː"),
    ("ng", "ŋ"),
    ("ß", "s"),
    ("é", "eː"),  # French loans: Café, Attaché
    ("ä", "ɛ"),
    ("ö", "œ"),
    ("ü", "ʏ"),
    ("b", "b"), ("d", "d"), ("f", "f"), ("g", "g"), ("h", "h"),
    ("j", "j"), ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"),
    ("p", "p"), ("r", "ʁ"), ("t", "t"), ("w", "v"), ("x", "k s"),
    ("z", "t͡s"),
    ("a", "a"), ("e", "ɛ"), ("i", "ɪ"), ("o", "ɔ"), ("u", "ʊ"),
    ("y", "yː"),
    ("c", "k"), ("q", "k"), ("v", "f"), ("s", "s"),
]

_LONG = {"a": "aː", "e": "eː", "i": "iː", "o": "oː", "u": "uː", "ä": "ɛː", "ö": "øː", "ü": "yː"}


_DOUBLE_MAP = {
    "b": "b", "d": "d", "f": "f", "g": "g", "l": "l", "m": "m",
    "n": "n", "p": "p", "r": "ʁ", "s": "s", "t": "t",
    "z": "t͡s",  # Italian loans: Pizza, Skizze — one affricate, not two
}

_VOWEL_LETTERS = "aeiouäöüy"


def _n_vowel_letters(word: str) -> int:
    return sum(c in _VOWEL_LETTERS for c in word)


def _context(word: str, i: int):
    ch = word[i]
    nxt = word[i + 1] if i + 1 < len(word) else ""
    nxt2 = word[i + 2] if i + 2 < len(word) else ""
    prev = word[i - 1] if i > 0 else ""

    # word-initial Greek rh (Rhein, Rhythmus) — NOT compound seams
    # like Jahr+hundert, where the h belongs to the next morpheme
    if i == 0 and word.startswith("rh") and len(word) > 3:
        return 2, ["ʁ"]
    if word.startswith("chs", i):
        return 3, ["k", "s"]
    if word.startswith("ch", i):
        if prev and prev in "aou":
            return 2, ["x"]
        return 2, ["ç"]
    # initial sp/st get ʃ
    if i == 0 and word.startswith("sp"):
        return 2, ["ʃ", "p"]
    if i == 0 and word.startswith("st"):
        return 2, ["ʃ", "t"]
    # ieh is long i with silent h (sieht, zieht, Vieh)
    if word.startswith("ieh", i):
        return 3, ["iː"]
    # -schaft suffix after a t-final stem: the t|sch morpheme boundary
    # must not merge into the t͡ʃ affricate (Wirtschaft, Botschaft)
    if ch == "t" and word.startswith("tschaft", i) and i > 0:
        return 1, ["t"]
    # ent- prefix before an sch- stem likewise (entscheiden,
    # entschlossen): the prefix-final t never affricates
    if ch == "t" and i == 2 and word.startswith("entsch"):
        return 1, ["t"]
    # -en- linker before -schaft stays schwa (Wissenschaften)
    if word.startswith("enschaft", i) and i > 0:
        return 2, ["ə", "n"]
    # -entlich adverbs carry an unstressed schwa (eigentlich, öffentlich,
    # hoffentlich, wesentlich, ordentlich)
    if word.startswith("entlich", i) and i > 0:
        return 7, ["ə", "n", "t", "l", "ɪ", "ç"]
    # word-final -erung after a consonant is the unstressed -er(n)+ung
    # nominalization with schwa (Änderung, Wanderung, Bevölkerung) — the
    # open-syllable default would read it [eːʁʊŋ].  A vowel before keeps
    # its own rule (Regierung: -ierung = [iːʁʊŋ]).
    if (
        word.startswith("erung", i)
        and i + 5 == len(word)
        and i > 0
        and prev not in "aeiouäöüy"
    ):
        return 5, ["ə", "ʁ", "ʊ", "ŋ"]
    # Latin -tion- is [tsjoːn] (Lektion, funktionieren); never word-initial
    if word.startswith("tion", i) and i > 0:
        return 4, ["t͡s", "j", "oː", "n"]
    # other Latin -ion finals are [joːn] (Version, Region, Diskussion)
    if word.startswith("ion", i) and i > 1 and i + 3 == len(word):
        return 3, ["j", "oː", "n"]
    # French -eur is [øːɐ] (Friseur, Amateur)
    if word.startswith("eur", i) and i > 0 and i + 3 == len(word):
        return 3, ["øː", "ɐ"]
    # word-final -ien in country/region names and Latin plurals is the
    # unstressed glide syllable [jən] (Italien, Spanien, Familien,
    # Ferien) — monosyllabic stems keep long i (Wien, knien)
    if (
        word.startswith("ien", i)
        and i + 3 == len(word)
        and i >= 2
        and prev not in _VOWEL_LETTERS
        and _n_vowel_letters(word) >= 3
    ):
        return 3, ["j", "ə", "n"]
    # -äisch adjectives read the ä long with a separate ɪ
    # (europäisch [ɔʏ̯ʁoːpɛːɪʃ])
    if word.startswith("äisch", i):
        return 2, ["ɛː", "ɪ"]
    # -igkeit keeps the ich-Laut (Schwierigkeit)
    if word.startswith("igkeit", i) and i > 0:
        return 6, ["ɪ", "ç", "k", "aɪ̯", "t"]
    # -enheit with linker schwa (Gelegenheit, Vergangenheit)
    if word.startswith("enheit", i) and i > 0:
        return 6, ["ə", "n", "h", "aɪ̯", "t"]
    # compound-final -tag/-hof/-zug keep their standalone long vowels
    # (Geburtstag, Hauptbahnhof, Schnellzug)
    if word.startswith("tag", i) and i > 0 and i + 3 == len(word):
        return 3, ["t", "aː", "k"]
    if word.startswith("hof", i) and i > 0 and i + 3 == len(word):
        return 3, ["h", "oː", "f"]
    if word.startswith("zug", i) and i > 0 and i + 3 == len(word):
        return 3, ["t͡s", "uː", "k"]
    # compound-initial flug-/zug- likewise (Flugzeug, Zugfahrt) — the
    # devoicing rule would otherwise leave the short default vowel
    if i == 0 and word.startswith("flug") and len(word) > 4:
        return 4, ["f", "l", "uː", "k"]
    if (
        i == 0
        and word.startswith("zug")
        and len(word) > 3
        and word[3] not in _VOWEL_LETTERS
        and word[3] not in "lr"  # zu+gleich, zu+grunde: g starts a cluster
    ):
        return 3, ["t͡s", "uː", "k"]
    # number-compound interiors keep their standalone reading: -hundert-
    # [hʊndɐt] and -tausend- [taʊzənt] (dreihundertfünf..., zweitausend...).
    # The final letter is left to the normal rules (devoicing / following e)
    if word.startswith("hunder", i):
        return 6, ["h", "ʊ", "n", "d", "ɐ"]
    if word.startswith("tausen", i):
        return 6, ["t", "aʊ̯", "z", "ə", "n"]
    # h after a vowel letter is mute — it lengthens (already consumed by
    # the ah/eh/... digraph rules) or separates syllables (gehen, blühen,
    # früh, weh).  Before a FULL vowel it starts a syllable and sounds
    # (Alkohol, Ahorn, Uhu); the da-hin/wo-her compounds are exceptions.
    if ch == "h" and prev and prev in _VOWEL_LETTERS and (
        not nxt or nxt not in "aou"
    ):
        return 1, []
    # unstressed er after a vowel is [ɐ] (dauer, feuer, bauer)
    if ch == "e" and nxt == "r" and prev and prev in _VOWEL_LETTERS:
        return 2, ["ɐ"]
    # -er- inside the common unstressed prefixes reduces to [ɐ] when the
    # word continues (unternehmen, hinterher, außerdem, wiederholen)
    if (
        ch == "e"
        and nxt == "r"
        and i + 2 < len(word)
        # a compound/derivation follows (unterNEHMEN, überALL) — but not
        # a bare inflection ending (untere, unserem)
        and word[i + 2 :] not in ("e", "en", "er", "em", "es", "n", "m", "s")
        and word[: i + 2] in ("unter", "hinter", "außer", "wieder",
                              "unser", "über", "aller")
    ):
        return 2, ["ɐ"]
    # -erweise adverb suffix (möglicherweise, glücklicherweise)
    if word.startswith("erweise", i) and i > 0 and i + 7 == len(word):
        return 7, ["ɐ", "v", "aɪ̯", "z", "ə"]
    # irgend- compounds keep the reduced [ɪʁgənt] (irgendwo, irgendwann)
    if i == 0 and word.startswith("irgend") and len(word) > 6:
        return 6, ["ɪ", "ʁ", "g", "ə", "n", "t"]
    # ß orthographically follows only long vowels/diphthongs (groß,
    # Straße, Großmutter)
    if ch in _LONG and nxt == "ß":
        return 1, [_LONG[ch]]
    # b/d/g devoice before a voiceless obstruent (liegt, Flugzeug,
    # Herbst, montags) — but stay voiced in onset clusters (Adler,
    # regnen); dt stays a plain digraph (Stadt)
    if (
        ch in "bdg"
        and nxt
        and nxt in "stkfpzcvß"
        and not (ch == "d" and nxt == "t")
    ):
        return 1, [{"b": "p", "d": "t", "g": "k"}[ch]]
    # s before vowel is voiced — except after a plosive onset (Psychologie,
    # Pseudonym keep voiceless [ps])
    if ch == "s" and nxt and nxt in _VOWEL_LETTERS:
        if i == 1 and word[0] == "p":
            return 1, ["s"]
        return 1, ["z"]
    # n assimilates before k (danke, trinken, links)
    if ch == "n" and nxt == "k":
        return 1, ["ŋ"]
    # doubled consonants are single sounds (the preceding vowel is
    # already short by default) — but s|sch compound seams keep both
    # sibilants (ausschließlich [s ʃ], not the ch fragment)
    if nxt == ch and ch in _DOUBLE_MAP:
        if ch == "s" and word.startswith("sch", i + 1):
            return 1, ["s"]
        return 2, [_DOUBLE_MAP[ch]]
    # word-final -ig says [ɪ ç] (standard pronunciation)
    if word.startswith("ig", i) and i + 2 == len(word) and len(word) > 3:
        return 2, ["ɪ", "ç"]
    # single-vowel word + single final consonant: long vowel (gut, Tag,
    # rot, groß); the short function words (mit, von, man, …) live in
    # _EXCEPTIONS
    if (
        ch in _LONG
        and len(word) - (i + 1) == 1
        and nxt not in _VOWEL_LETTERS
        and nxt != "r"
        and _n_vowel_letters(word) == 1
        and len(word) >= 3
    ):
        return 1, [_LONG[ch]]
    # single-vowel word + final r: long vowel + vocalized r (der, für)
    if (
        ch in _LONG
        and nxt == "r"
        and i + 2 == len(word)
        and _n_vowel_letters(word) == 1
    ):
        return 2, [_LONG[ch], "ɐ"]
    # final r after a vowel vocalizes (vier, Bier, Jahr)
    if ch == "r" and i + 1 == len(word) and prev in _VOWEL_LETTERS + "h":
        return 1, ["ɐ"]
    # final vowels: monosyllables are long (zu, so, ja); polysyllabic
    # final i/o/u/ä/ö/ü keep the tense (long) symbol — the inventory
    # has no short tense vowels — while final unstressed a is short
    # (China, Kamera) and final e is schwa (handled below)
    if ch in _LONG and ch != "e" and i + 1 == len(word) and len(word) > 1:
        if ch == "a" and _n_vowel_letters(word) > 1:
            return 1, ["a"]
        return 1, [_LONG[ch]]
    # unstressed e in final syllables of polysyllables:
    # -e/-en/-el/-em/-es/-et/-eln/-elt and -er/-ern/-ert (-> ɐ),
    # -end/-ent (abend, tausend)
    if ch == "e" and _n_vowel_letters(word[:i]) >= 1:
        tail = word[i:]
        _tail_map = {"d": "t"}  # final devoicing inside the ending
        if tail in ("er", "ern", "ert"):
            return len(tail), ["ɐ"] + [_tail_map.get(c, c) for c in tail[2:]]
        # NOT -ent: German -ent loans are stressed [ɛnt] (Student, Moment)
        if tail in ("e", "en", "el", "em", "es", "et", "eln", "elt",
                    "end", "ens", "ends", "els"):
            return len(tail), ["ə"] + [_tail_map.get(c, c) for c in tail[1:]]
        if tail in ("ers", "erns"):
            return len(tail), ["ɐ"] + [_tail_map.get(c, c) for c in tail[2:]]
        # weak-verb past -ete after a d/t stem (endete, arbeitete) —
        # NOT the stressed loan -ete (Rakete, Tapete, Pakete)
        if tail in ("ete", "eten", "etet") and prev in "dt":
            return len(tail), ["ə", "t"] + (
                ["ə"] + list(tail[3:]) if len(tail) > 3 else ["ə"]
            )
    # open-syllable vowel lengthening: vowel + single consonant + vowel
    if (
        ch in _LONG
        and i + 2 < len(word)
        and nxt and nxt not in _VOWEL_LETTERS
        and nxt != word[i + 2]
        and word[i + 2] in _VOWEL_LETTERS
        and not word.startswith("ch", i + 1)
        and not word.startswith("sch", i + 1)
    ):
        return 1, [_LONG[ch]]
    # final devoicing
    if ch in "bdg" and i + 1 == len(word):
        return 1, [{"b": "p", "d": "t", "g": "k"}[ch]]
    return None


# Irregulars and morphology the letter rules cannot see: unstressed
# ge-/be- prefixes (vs ge-/be- stems like "geben"), unpredictable vowel
# length before ch, loanword stress shapes.  Hand-verified standard German.
_EXCEPTIONS: typing.Dict[str, typing.Tuple[str, ...]] = {
    # muta-cum-liquida open syllables the cluster heuristic misses
    "übrig": ("yː", "b", "ʁ", "ɪ", "ç"),
    "übrigens": ("yː", "b", "ʁ", "ɪ", "g", "ə", "n", "s"),
    # measurement vocabulary (Latin/English loans)
    "celsius": ("t͡s", "ɛ", "l", "z", "j", "ʊ", "s"),
    "fahrenheit": ("f", "aː", "ʁ", "ə", "n", "h", "aɪ̯", "t"),
    "viertel": ("f", "ɪ", "ʁ", "t", "ə", "l"),
    "byte": ("b", "aɪ̯", "t"),
    "kilobyte": ("k", "iː", "l", "oː", "b", "aɪ̯", "t"),
    "megabyte": ("m", "eː", "g", "aː", "b", "aɪ̯", "t"),
    "gigabyte": ("g", "iː", "g", "aː", "b", "aɪ̯", "t"),
    "terabyte": ("t", "eː", "ʁ", "aː", "b", "aɪ̯", "t"),
    "hertz": ("h", "ɛ", "ʁ", "t͡s"),
    "kilohertz": ("k", "iː", "l", "oː", "h", "ɛ", "ʁ", "t͡s"),
    "megahertz": ("m", "eː", "g", "aː", "h", "ɛ", "ʁ", "t͡s"),
    "gigahertz": ("g", "iː", "g", "aː", "h", "ɛ", "ʁ", "t͡s"),
    "buch": ("b", "uː", "x"),
    "bücher": ("b", "yː", "ç", "ɐ"),
    "tuch": ("t", "uː", "x"),
    "kuchen": ("k", "uː", "x", "ə", "n"),
    "suchen": ("z", "uː", "x", "ə", "n"),
    "besuchen": ("b", "ə", "z", "uː", "x", "ə", "n"),
    "sprache": ("ʃ", "p", "ʁ", "aː", "x", "ə"),
    "mädchen": ("m", "ɛː", "t", "ç", "ə", "n"),
    "städte": ("ʃ", "t", "ɛ", "t", "ə"),
    "hotel": ("h", "oː", "t", "ɛ", "l"),
    "kaffee": ("k", "a", "f", "eː"),
    "familie": ("f", "a", "m", "iː", "l", "j", "ə"),
    # -ie finals that read [jə] instead of stressed [iː] (lexical class)
    "linie": ("l", "iː", "n", "j", "ə"),
    "serie": ("z", "eː", "ʁ", "j", "ə"),
    "studie": ("ʃ", "t", "uː", "d", "j", "ə"),
    "aktie": ("a", "k", "t͡s", "j", "ə"),
    "folie": ("f", "oː", "l", "j", "ə"),
    "bequem": ("b", "ə", "k", "v", "eː", "m"),
    "handy": ("h", "ɛ", "n", "d", "iː"),
    # English tech loans (Duden-style eindeutschung)
    "email": ("iː", "m", "eː", "l"),
    "e-mail": ("iː", "m", "eː", "l"),
    "website": ("v", "ɛ", "p", "s", "aɪ̯", "t"),
    "online": ("ɔ", "n", "l", "aɪ̯", "n"),
    "offline": ("ɔ", "f", "l", "aɪ̯", "n"),
    "software": ("z", "ɔ", "f", "t", "v", "ɛː", "ɐ"),
    "hardware": ("h", "a", "ʁ", "t", "v", "ɛː", "ɐ"),
    "smartphone": ("s", "m", "a", "ʁ", "t", "f", "oː", "n"),
    "app": ("ɛ", "p"),
    "apps": ("ɛ", "p", "s"),
    "laptop": ("l", "ɛ", "p", "t", "ɔ", "p"),
    "google": ("g", "uː", "g", "ə", "l"),
    "youtube": ("j", "uː", "t", "uː", "p"),
    "download": ("d", "aʊ̯", "n", "l", "oː", "t"),
    "downloads": ("d", "aʊ̯", "n", "l", "oː", "t", "s"),
    "browser": ("b", "ʁ", "aʊ̯", "z", "ɐ"),
    "server": ("s", "ɛ", "ʁ", "v", "ɐ"),
    "update": ("a", "p", "d", "eː", "t"),
    "updates": ("a", "p", "d", "eː", "t", "s"),
    "wifi": ("v", "aɪ̯", "f", "aɪ̯"),
    "wlan": ("v", "eː", "l", "aː", "n"),
    "restaurant": ("ʁ", "ɛ", "s", "t", "oː", "ʁ", "ãː"),
    "internet": ("ɪ", "n", "t", "ɐ", "n", "ɛ", "t"),
    "außerdem": ("aʊ̯", "s", "ɐ", "d", "eː", "m"),
    "familien": ("f", "a", "m", "iː", "l", "j", "ə", "n"),
    "hinterher": ("h", "ɪ", "n", "t", "ɐ", "h", "eː", "ɐ"),
    "untere": ("ʊ", "n", "t", "ə", "ʁ", "ə"),
    "unteren": ("ʊ", "n", "t", "ə", "ʁ", "ə", "n"),
    "unterer": ("ʊ", "n", "t", "ə", "ʁ", "ɐ"),
    "modern": ("m", "oː", "d", "ɛ", "ʁ", "n"),
    # superlatives of -ch adjectives keep the ich-Laut across the +st
    # seam (the chs -> [ks] digraph is for wachsen/sechs-class stems)
    "höchste": ("h", "øː", "ç", "s", "t", "ə"),
    "höchsten": ("h", "øː", "ç", "s", "t", "ə", "n"),
    "höchster": ("h", "øː", "ç", "s", "t", "ɐ"),
    "höchstens": ("h", "øː", "ç", "s", "t", "ə", "n", "s"),
    "nächste": ("n", "ɛː", "ç", "s", "t", "ə"),
    "nächsten": ("n", "ɛː", "ç", "s", "t", "ə", "n"),
    "nächster": ("n", "ɛː", "ç", "s", "t", "ɐ"),
    "nächstes": ("n", "ɛː", "ç", "s", "t", "ə", "s"),
    "schwächste": ("ʃ", "v", "ɛ", "ç", "s", "t", "ə"),
    "schwächsten": ("ʃ", "v", "ɛ", "ç", "s", "t", "ə", "n"),
    "österreich": ("øː", "s", "t", "ɐ", "ʁ", "aɪ̯", "ç"),
    "österreichs": ("øː", "s", "t", "ɐ", "ʁ", "aɪ̯", "ç", "s"),
    "geordnet": ("g", "ə", "ɔ", "ʁ", "d", "n", "ə", "t"),
    "rhythmus": ("ʁ", "ʏ", "t", "m", "ʊ", "s"),
    "gesicht": ("g", "ə", "z", "ɪ", "ç", "t"),
    "gesehen": ("g", "ə", "z", "eː", "ə", "n"),
    "gesagt": ("g", "ə", "z", "aː", "k", "t"),
    "gemacht": ("g", "ə", "m", "a", "x", "t"),
    "gewesen": ("g", "ə", "v", "eː", "z", "ə", "n"),
    "geworden": ("g", "ə", "v", "ɔ", "ʁ", "d", "ə", "n"),
    "gefunden": ("g", "ə", "f", "ʊ", "n", "d", "ə", "n"),
    "gegangen": ("g", "ə", "g", "a", "ŋ", "ə", "n"),
    "gekommen": ("g", "ə", "k", "ɔ", "m", "ə", "n"),
    "genommen": ("g", "ə", "n", "ɔ", "m", "ə", "n"),
    "geschrieben": ("g", "ə", "ʃ", "ʁ", "iː", "b", "ə", "n"),
    "gesprochen": ("g", "ə", "ʃ", "p", "ʁ", "ɔ", "x", "ə", "n"),
    "genug": ("g", "ə", "n", "uː", "k"),
    "gehört": ("g", "ə", "h", "øː", "ɐ", "t"),
    "gegeben": ("g", "ə", "g", "eː", "b", "ə", "n"),
    "geschichte": ("g", "ə", "ʃ", "ɪ", "ç", "t", "ə"),
    "bekommen": ("b", "ə", "k", "ɔ", "m", "ə", "n"),
    "beginnen": ("b", "ə", "g", "ɪ", "n", "ə", "n"),
    "bezahlen": ("b", "ə", "t͡s", "aː", "l", "ə", "n"),
    "bedeuten": ("b", "ə", "d", "ɔʏ̯", "t", "ə", "n"),
    "behalten": ("b", "ə", "h", "a", "l", "t", "ə", "n"),
    "vielen": ("f", "iː", "l", "ə", "n"),
    "dank": ("d", "a", "ŋ", "k"),
    "danke": ("d", "a", "ŋ", "k", "ə"),
    "denken": ("d", "ɛ", "ŋ", "k", "ə", "n"),
    "trinken": ("t", "ʁ", "ɪ", "ŋ", "k", "ə", "n"),
    "bank": ("b", "a", "ŋ", "k"),
    "punkt": ("p", "ʊ", "ŋ", "k", "t"),
    "links": ("l", "ɪ", "ŋ", "k", "s"),
    "krank": ("k", "ʁ", "a", "ŋ", "k"),
    "schmecken": ("ʃ", "m", "ɛ", "k", "ə", "n"),
    "mögen": ("m", "øː", "g", "ə", "n"),
    "montag": ("m", "oː", "n", "t", "aː", "k"),
    "dienstag": ("d", "iː", "n", "s", "t", "aː", "k"),
    "mittwoch": ("m", "ɪ", "t", "v", "ɔ", "x"),
    "donnerstag": ("d", "ɔ", "n", "ɐ", "s", "t", "aː", "k"),
    "freitag": ("f", "ʁ", "aɪ̯", "t", "aː", "k"),
    "samstag": ("z", "a", "m", "s", "t", "aː", "k"),
    "sonntag": ("z", "ɔ", "n", "t", "aː", "k"),
    "nämlich": ("n", "ɛː", "m", "l", "ɪ", "ç"),
    "natürlich": ("n", "a", "t", "yː", "ɐ", "l", "ɪ", "ç"),
    "wirklich": ("v", "ɪ", "ʁ", "k", "l", "ɪ", "ç"),
    "deutschland": ("d", "ɔʏ̯", "t͡ʃ", "l", "a", "n", "t"),
    "herr": ("h", "ɛ", "ʁ"),
    "krankenhaus": ("k", "ʁ", "a", "ŋ", "k", "ə", "n", "h", "aʊ̯", "s"),
    "wissenschaft": ("v", "ɪ", "s", "ə", "n", "ʃ", "a", "f", "t"),
    "straßenbahn": ("ʃ", "t", "ʁ", "aː", "s", "ə", "n", "b", "aː", "n"),
    "haltestelle": ("h", "a", "l", "t", "ə", "ʃ", "t", "ɛ", "l", "ə"),
    "million": ("m", "ɪ", "l", "j", "oː", "n"),
    "millionen": ("m", "ɪ", "l", "j", "oː", "n", "ə", "n"),
    "milliarde": ("m", "ɪ", "l", "j", "a", "ʁ", "d", "ə"),
    "computer": ("k", "ɔ", "m", "p", "j", "uː", "t", "ɐ"),
    "telefon": ("t", "eː", "l", "eː", "f", "oː", "n"),
    "november": ("n", "oː", "v", "ɛ", "m", "b", "ɐ"),
    "universität": ("ʔ", "ʊ", "n", "iː", "v", "ɛ", "ʁ", "z", "iː", "t", "ɛː", "t"),
    "cousin": ("k", "uː", "z", "ɛ̃ː"),
    "orange": ("ʔ", "oː", "ʁ", "ãː", "ʒ", "ə"),
    "violett": ("v", "iː", "oː", "l", "ɛ", "t"),
    "fahrrad": ("f", "aː", "ɐ", "ʁ", "aː", "t"),
    "fahrräder": ("f", "aː", "ɐ", "ʁ", "ɛː", "d", "ɐ"),
    "trotzdem": ("t", "ʁ", "ɔ", "t͡s", "d", "eː", "m"),
    "erde": ("eː", "ɐ", "d", "ə"),
    "mit": ("m", "ɪ", "t"),
    "von": ("f", "ɔ", "n"),
    "man": ("m", "a", "n"),
    "bin": ("b", "ɪ", "n"),
    "hat": ("h", "a", "t"),
    "bis": ("b", "ɪ", "s"),
    "ob": ("ɔ", "p"),
    "ab": ("a", "p"),
    "um": ("ʊ", "m"),
    "an": ("a", "n"),
    "in": ("ɪ", "n"),
    "hin": ("h", "ɪ", "n"),
    "des": ("d", "ɛ", "s"),
    "was": ("v", "a", "s"),
    "das": ("d", "a", "s"),
    "dass": ("d", "a", "s"),
    "gott": ("g", "ɔ", "t"),
    "herren": ("h", "ɛ", "ʁ", "ə", "n"),
    "bahnhof": ("b", "aː", "n", "h", "oː", "f"),
    "daher": ("d", "a", "h", "eː", "ɐ"),
    "doktor": ("d", "ɔ", "k", "t", "oː", "ɐ"),
    "professor": ("p", "ʁ", "oː", "f", "ɛ", "s", "oː", "ɐ"),
    "zirka": ("t͡s", "ɪ", "ʁ", "k", "a"),
    "dahin": ("d", "a", "h", "ɪ", "n"),
    "woher": ("v", "oː", "h", "eː", "ɐ"),
    "wohin": ("v", "oː", "h", "ɪ", "n"),
    "vorher": ("f", "oː", "ɐ", "h", "eː", "ɐ"),
    "vorhin": ("f", "oː", "ɐ", "h", "ɪ", "n"),
    "erklärt": ("ɛ", "ʁ", "k", "l", "ɛː", "ʁ", "t"),
    "entschuldigung": ("ɛ", "n", "t", "ʃ", "ʊ", "l", "d", "ɪ", "g",
                       "ʊ", "ŋ"),
    "selbstverständlich": ("z", "ɛ", "l", "p", "s", "t", "f", "ɛ", "ʁ",
                           "ʃ", "t", "ɛ", "n", "t", "l", "ɪ", "ç"),
    "flughafen": ("f", "l", "uː", "k", "h", "aː", "f", "ə", "n"),
    "toilette": ("t", "ɔ", "a", "l", "ɛ", "t", "ə"),
    "garage": ("g", "a", "ʁ", "aː", "ʒ", "ə"),
    "etage": ("eː", "t", "aː", "ʒ", "ə"),
    "wochenende": ("v", "ɔ", "x", "ə", "n", "ɛ", "n", "d", "ə"),
    "krankenwagen": ("k", "ʁ", "a", "ŋ", "k", "ə", "n", "v", "aː", "g",
                     "ə", "n"),
    "orangensaft": ("oː", "ʁ", "ãː", "ʒ", "ə", "n", "z", "a", "f", "t"),
    "erklären": ("ɛ", "ʁ", "k", "l", "ɛː", "ʁ", "ə", "n"),
    "erklärte": ("ɛ", "ʁ", "k", "l", "ɛː", "ʁ", "t", "ə"),
    "besuch": ("b", "ə", "z", "uː", "x"),
    "berlin": ("b", "ɛ", "ʁ", "l", "iː", "n"),
    "bus": ("b", "ʊ", "s"),
    "busse": ("b", "ʊ", "s", "ə"),
    "schläft": ("ʃ", "l", "ɛː", "f", "t"),
    "sprach": ("ʃ", "p", "ʁ", "aː", "x"),
    "sprachen": ("ʃ", "p", "ʁ", "aː", "x", "ə", "n"),
    "regnen": ("ʁ", "eː", "g", "n", "ə", "n"),
    "regnet": ("ʁ", "eː", "g", "n", "ə", "t"),
    "museum": ("m", "ʊ", "z", "eː", "ʊ", "m"),
    "museen": ("m", "ʊ", "z", "eː", "ə", "n"),
    "theater": ("t", "eː", "aː", "t", "ɐ"),
    "konzert": ("k", "ɔ", "n", "t͡s", "ɛ", "ʁ", "t"),
    "konzerte": ("k", "ɔ", "n", "t͡s", "ɛ", "ʁ", "t", "ə"),
    "medizin": ("m", "eː", "d", "iː", "t͡s", "iː", "n"),
    "täglich": ("t", "ɛː", "k", "l", "ɪ", "ç"),
    "einmal": ("aɪ̯", "n", "m", "aː", "l"),
    "zweimal": ("t͡s", "v", "aɪ̯", "m", "aː", "l"),
    "dreimal": ("d", "ʁ", "aɪ̯", "m", "aː", "l"),
    "manchmal": ("m", "a", "n", "ç", "m", "aː", "l"),
    "langsam": ("l", "a", "ŋ", "z", "aː", "m"),
    "diktat": ("d", "ɪ", "k", "t", "aː", "t"),
    "bibliothek": ("b", "ɪ", "b", "l", "ɪ", "oː", "t", "eː", "k"),
    "fabrik": ("f", "a", "b", "ʁ", "iː", "k"),
    "autos": ("aʊ̯", "t", "oː", "s"),
    "ingenieur": ("ɪ", "n", "ʒ", "eː", "n", "j", "øː", "ɐ"),
    "ingenieure": ("ɪ", "n", "ʒ", "eː", "n", "j", "øː", "ʁ", "ə"),
    "monatsende": ("m", "oː", "n", "a", "t", "s", "ɛ", "n", "d", "ə"),
    "urlaub": ("uː", "ɐ", "l", "aʊ̯", "p"),
    "wunderbar": ("v", "ʊ", "n", "d", "ɐ", "b", "aː", "ɐ"),
    "vorsicht": ("f", "oː", "ɐ", "z", "ɪ", "ç", "t"),
    "lehrerin": ("l", "eː", "ʁ", "ə", "ʁ", "ɪ", "n"),
    "obst": ("oː", "p", "s", "t"),
    "sprechstunde": ("ʃ", "p", "ʁ", "ɛ", "ç", "ʃ", "t", "ʊ", "n", "d", "ə"),
    "abendessen": ("aː", "b", "ə", "n", "t", "ɛ", "s", "ə", "n"),
    "montags": ("m", "oː", "n", "t", "aː", "k", "s"),
    "dienstags": ("d", "iː", "n", "s", "t", "aː", "k", "s"),
    "mittwochs": ("m", "ɪ", "t", "v", "ɔ", "x", "s"),
    "donnerstags": ("d", "ɔ", "n", "ɐ", "s", "t", "aː", "k", "s"),
    "freitags": ("f", "ʁ", "aɪ̯", "t", "aː", "k", "s"),
    "samstags": ("z", "a", "m", "s", "t", "aː", "k", "s"),
    "sonntags": ("z", "ɔ", "n", "t", "aː", "k", "s"),
}


# Words whose initial ge-/be- is part of the stem, not the unstressed
# prefix (ge-ben, ges-tern, bes-ser) — the prefix heuristic must skip them.
_NOT_PREFIXED = frozenset({
    "geben", "gebe", "gebt", "gegen", "gegend", "gehen", "gehe", "geht",
    "gestern", "gerne", "geste", "gesten", "general", "gelbe", "gelben",
    "gelber", "gelbes", "genen", "gene",
    "besen", "beten", "betet", "bete", "beben", "bebt", "beere",
    "beeren", "berge", "bergen", "besser", "beste", "besten", "bester",
    "bestes", "betten", "beide", "beiden", "beides",
})

# Separable-participle prefixes: <prefix>ge<stem> (abgeschlossen,
# aufgemacht) — pronounced prefix + [gə] + stem.
_SEP_GE_PREFIXES = {
    "abge": ["a", "p", "g", "ə"],
    "aufge": ["aʊ̯", "f", "g", "ə"],
    "ausge": ["aʊ̯", "s", "g", "ə"],
    "ange": ["a", "n", "g", "ə"],
    "einge": ["aɪ̯", "n", "g", "ə"],
    "vorge": ["f", "oː", "ɐ", "g", "ə"],
    "mitge": ["m", "ɪ", "t", "g", "ə"],
    "nachge": ["n", "aː", "x", "g", "ə"],
    "wegge": ["v", "ɛ", "k", "g", "ə"],
    "zuge": ["t͡s", "uː", "g", "ə"],
}


def _has_vowel(s: str) -> bool:
    return any(c in _VOWEL_LETTERS for c in s)


_VALID_ONSET_2 = frozenset({
    "bl", "br", "dr", "fl", "fr", "gl", "gr", "gn", "kl", "kn", "kr",
    "pf", "pl", "pr", "qu", "sp", "st", "tr", "zw", "sk", "ch",
})


def _valid_stem_start(rest: str) -> bool:
    """Could ``rest`` begin a German stem after an unstressed prefix?"""
    if rest[0] in "äöü":
        return True  # geöffnet, geändert, geübt
    if rest[0] == "a":
        return True  # ge-arbeitet, be-antwortet (no native gea-/bea- stems)
    if rest[0] in _VOWEL_LETTERS:
        # other plain vowels collide with diphthong/Greek stems
        # (beute, geist, geografie) — handled case by case
        return False
    if len(rest) >= 2 and rest[1] in _VOWEL_LETTERS:
        return True  # single consonant + vowel (gesund, bekam)
    return rest.startswith("sch") or rest[:2] in _VALID_ONSET_2


# German letter names (spell-out and ALL-CAPS initialisms)
_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "a": ["aː"], "b": ["b", "eː"], "c": ["t͡s", "eː"], "d": ["d", "eː"],
    "e": ["eː"], "f": ["ɛ", "f"], "g": ["g", "eː"], "h": ["h", "aː"],
    "i": ["iː"], "j": ["j", "ɔ", "t"], "k": ["k", "aː"],
    "l": ["ɛ", "l"], "m": ["ɛ", "m"], "n": ["ɛ", "n"], "o": ["oː"],
    "p": ["p", "eː"], "q": ["k", "uː"], "r": ["ɛ", "ʁ"],
    "s": ["ɛ", "s"], "t": ["t", "eː"], "u": ["uː"],
    "v": ["f", "aʊ̯"], "w": ["v", "eː"], "x": ["ɪ", "k", "s"],
    "y": ["ʏ", "p", "s", "iː", "l", "ɔ", "n"], "z": ["t͡s", "ɛ", "t"],
    "ä": ["ɛː"], "ö": ["øː"], "ü": ["yː"], "ß": ["ɛ", "s", "t͡s", "ɛ", "t"],
}


# common words that appear fully capitalized for emphasis — never spell
_CAPS_WORDS = frozenset("""
ja so nun wie was wer wo ab an am im in zu um es er du wir ihr sie
der die und oder aber nein mit von bis für auf aus ist sind hat kein
neu gut alt nie nur
""".split())




def phonemize(word: str) -> typing.List[str]:
    w = word.lower().strip()
    if not w:
        return []
    # ALL-CAPS initialisms spell their letters (EU, BRD, LKW) — German
    # nouns are Titlecase, so full caps marks an abbreviation; readable
    # acronyms (NATO, UNO) stay words
    if (
        word.isupper()
        and word.isalpha()
        and 2 <= len(word) <= 6
        and w not in _EXCEPTIONS
        and w not in _CAPS_WORDS
        and ((len(w) <= 3 and w != "uno") or not acronym_readable(w, _VOWEL_LETTERS))
    ):
        return spell_letters(w, _LETTER_NAMES)
    if len(w) == 1 and w.isalpha():
        return spell_letters(w, _LETTER_NAMES)  # spelled single letter
    hit = _EXCEPTIONS.get(w)
    if hit is not None:
        return list(hit)
    # unstressed ge-/be- prefixes reduce to [gə]/[bə]; the stem is
    # phonemized on its own so stem-initial rules (sp/st -> ʃ, vowel
    # length) apply (geschah -> gə+ʃaː, beginnt -> bə+gɪnt).  A stem
    # must start with a plausible onset (or umlaut: geöffnet) and
    # contain a vowel; stem-initial ge/be words are blocklisted.
    if w not in _NOT_PREFIXED and len(w) > 4:
        head, rest = w[:2], w[2:]
        if head in ("ge", "be") and _has_vowel(rest) and (
            _valid_stem_start(rest)
            or (head == "be" and rest[0] == "e")
            or (head == "ge" and rest[0] == "u")  # ge-urteilt, ge-übt
        ):
            return [head[0], "ə"] + phonemize(rest)
        for pre, sounds in _SEP_GE_PREFIXES.items():
            if (
                w.startswith(pre)
                and _has_vowel(w[len(pre):])
                and len(w) > len(pre) + 2
            ):
                return list(sounds) + phonemize(w[len(pre):])
        # ver-/er-/zer- before stem-initial st/sp: the cluster is
        # morpheme-initial and says ʃ (verstehen, versprechen)
        for pre, sounds in (
            ("ver", ["f", "ɛ", "ʁ"]),
            ("zer", ["t͡s", "ɛ", "ʁ"]),
        ):
            if (
                w.startswith(pre)
                and w[len(pre):].startswith(("st", "sp"))
                and _has_vowel(w[len(pre) + 2:])
            ):
                return list(sounds) + phonemize(w[len(pre):])
        # un- before g is a morpheme boundary (ungefähr, unglaublich,
        # ungünstig): n|g must not merge into ŋ; Ungarn/ungarisch keep
        # the word-internal ŋ
        if (
            w.startswith("ung")
            and len(w) > 5
            and not w.startswith("ungar")
            and _has_vowel(w[3:])
        ):
            return ["ʊ", "n"] + phonemize(w[2:])
        # ver-/zer-/er- before a VOWEL-initial stem keep the short open
        # prefix vowel (verein, verantwortlich, erinnern) — the general
        # rules would read the open-syllable e long ([feːʁ...])
        for pre, sounds in (
            ("ver", ["f", "ɛ", "ʁ"]),
            ("zer", ["t͡s", "ɛ", "ʁ"]),
            ("er", ["ɛ", "ʁ"]),
        ):
            rest = w[len(pre):]
            if (
                w.startswith(pre)
                and len(rest) >= 3
                and rest[0] in "aeiouäöü"
                and _has_vowel(rest[1:])
            ):
                return list(sounds) + phonemize(rest)
    return apply_rules(w, _RULES, _context)
