# Copied from larynx_tpu/text/g2p/it.py; only the package name in its imports differs.
"""Italian G2P — rule-based; Italian orthography is largely phonemic.

Inventory (local/it-it/*/phonemes.txt): a b d d͡z d͡ʒ e f i j k l m n o p r
s t t͡s t͡ʃ u v w z ŋ ɔ ɛ ɡ ɱ ɲ ʃ ʎ + ˈ ˌ.
"""

import typing

from larynx_tpu_torch.text.g2p.rules import (
    acronym_readable,
    apply_rules,
    apply_rules_span,
    shift_stress_to_onset,
    spell_letters,
    stress_nth_vowel_from_end,
)

VOWELS = {"a", "e", "i", "o", "u", "ɔ", "ɛ"}

_ACCENTED = {"à": "a", "è": "ɛ", "é": "e", "ì": "i", "ò": "ɔ", "ó": "o", "ù": "u"}
# base ORTHOGRAPHIC letter (for rule-context walks; _ACCENTED values are
# the emitted phoneme qualities, which differ for è/ò)
_BASE = {"à": "a", "è": "e", "é": "e", "ì": "i", "ò": "o", "ó": "o", "ù": "u"}

_RULES = [
    ("sci", "ʃ"), ("sce", "ʃ e"),
    ("gli", "ʎ"), ("gn", "ɲ"),
    ("chi", "k i"), ("che", "k e"), ("ch", "k"),
    ("ghi", "ɡ i"), ("ghe", "ɡ e"), ("gh", "ɡ"),
    ("ce", "t͡ʃ e"),
    ("ge", "d͡ʒ e"),
    ("qu", "k w"),
    ("zz", "t t͡s"),
    ("ɛ", "ɛ"), ("ɔ", "ɔ"),  # pre-substituted accented vowels (è, ò)
    ("a", "a"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "e"),
    ("f", "f"), ("g", "ɡ"), ("h", ""), ("i", "i"), ("j", "j"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "o"),
    ("p", "p"), ("q", "k"), ("r", "r"), ("s", "s"), ("t", "t"),
    ("u", "u"), ("v", "v"), ("w", "w"), ("x", "k s"), ("y", "i"),
    ("z", "t͡s"),
]


_SOFT = {"c": "t͡ʃ", "g": "d͡ʒ"}


def _context(word: str, i: int):
    ch = word[i]
    nxt = word[i + 1] if i + 1 < len(word) else ""
    nxt2 = word[i + 2] if i + 2 < len(word) else ""
    prev = word[i - 1] if i > 0 else ""
    prev2 = word[i - 2] if i > 1 else ""

    # sci: the i is a marker before a/o/u (sciare -> ʃa), a vowel
    # otherwise (pesci -> ʃi, uscire -> ʃi)
    if word.startswith("sci", i):
        nxt3 = word[i + 3] if i + 3 < len(word) else ""
        if nxt3 and nxt3 in "aou":
            return 3, ["ʃ"]
        if nxt3 == "e":
            return 4, ["ʃ", "e"]
        return 3, ["ʃ", "i"]
    # chi/ghi + vowel: the i is a glide (occhio -> k k j o)
    if ch in "cg" and word.startswith("h", i + 1) and nxt2 == "i":
        nxt3 = word[i + 3] if i + 3 < len(word) else ""
        hard = "k" if ch == "c" else "ɡ"
        if nxt3 and nxt3 in "aeou":
            return 3, [hard, "j"]
        return 3, [hard, "i"]
    # c/g before i: the i is silent before a vowel (giorno -> d͡ʒ o),
    # a real vowel otherwise (città -> t͡ʃ i, cinque -> t͡ʃ i n)
    if ch in "cg" and nxt == "i":
        if nxt2 and nxt2 in "aou":
            return 2, [_SOFT[ch]]
        if nxt2 == "e":  # cielo -> t͡ʃ e
            return 3, [_SOFT[ch], "e"]
        return 2, [_SOFT[ch], "i"]
    # doubled c/g before front vowels: geminate affricate
    # (faccia -> t t͡ʃ, oggi -> d d͡ʒ)
    if ch in "cg" and nxt == ch and nxt2 and nxt2 in "ei":
        first = "t" if ch == "c" else "d"
        if nxt2 == "e":
            return 2, [first, _SOFT[ch]]
        sub = _context(word, i + 1)
        if sub is not None:
            length, phones = sub
            return 1 + length, [first] + phones
    # gli: palatal lateral; word-final (or the article "gli") keeps
    # the i as a vowel
    if word.startswith("gli", i):
        if i + 3 == len(word):
            return 3, ["ʎ", "i"]
        if word[i + 3] in "aeou":
            return 3, ["ʎ"]
    # uo is always open o (uomo, buono, cuore) — two single-char claims
    # so an accent split between u and ò can't double-emit the vowel
    # (può: the before-span ends between them)
    if ch == "u" and nxt == "o":
        return 1, ["w"]
    if ch == "o" and prev == "u" and prev2 != "q":
        # prev2 == "q": the u belonged to the plain qu -> k w rule and
        # this o is an ordinary vowel (quota)
        return 1, ["ɔ"]
    # intervocalic s is voiced
    if ch == "s" and prev and prev in "aeiou" and nxt and nxt in "aeiou":
        return 1, ["z"]
    # i before vowel is a glide; i after a vowel at word end closes a
    # falling diphthong (lui, mai) — but not after the glide u of qu/gu
    if ch == "i" and nxt and nxt in "aeou" and (not prev or prev not in "cg"):
        return 1, ["j"]
    if (
        ch == "i"
        and nxt == ""
        and prev and prev in "aeou"
        and not (prev == "u" and prev2 in "qg")
    ):
        return 1, ["j"]
    if ch == "u" and nxt and (nxt in "ae" or (nxt == "i" and prev in "qg")):
        return 1, ["w"]
    return None


# Lexical open-vowel quality (ɛ/ɔ) and voiced z — not recoverable from
# spelling; hand-verified standard Italian for high-frequency words.
_EXCEPTIONS: typing.Dict[str, typing.Tuple[str, ...]] = {
    "bene": ("b", "ɛ", "n", "e"),
    "bello": ("b", "ɛ", "l", "l", "o"),
    "bella": ("b", "ɛ", "l", "l", "a"),
    "sette": ("s", "ɛ", "t", "t", "e"),
    "otto": ("ɔ", "t", "t", "o"),
    "nove": ("n", "ɔ", "v", "e"),
    "notte": ("n", "ɔ", "t", "t", "e"),
    "donna": ("d", "ɔ", "n", "n", "a"),
    "oggi": ("ɔ", "d", "d͡ʒ", "i"),
    "cosa": ("k", "ɔ", "z", "a"),
    "posto": ("p", "ɔ", "s", "t", "o"),
    "porta": ("p", "ɔ", "r", "t", "a"),
    "forte": ("f", "ɔ", "r", "t", "e"),
    "tempo": ("t", "ɛ", "m", "p", "o"),
    "festa": ("f", "ɛ", "s", "t", "a"),
    "terra": ("t", "ɛ", "r", "r", "a"),
    "guerra": ("ɡ", "w", "ɛ", "r", "r", "a"),
    "dieci": ("d", "j", "ɛ", "t͡ʃ", "i"),
    "ieri": ("j", "ɛ", "r", "i"),
    "lei": ("l", "ɛ", "j"),
    "sei": ("s", "ɛ", "j"),
    "piede": ("p", "j", "ɛ", "d", "e"),
    "zero": ("d͡z", "ɛ", "r", "o"),
    "mezzo": ("m", "ɛ", "d", "d͡z", "o"),
    "pranzo": ("p", "r", "a", "n", "d͡z", "o"),
    "zona": ("d͡z", "ɔ", "n", "a"),
    "uovo": ("w", "ɔ", "v", "o"),
    "erba": ("ɛ", "r", "b", "a"),
    "estate": ("e", "s", "t", "a", "t", "e"),
    "petto": ("p", "ɛ", "t", "t", "o"),
    "letto": ("l", "ɛ", "t", "t", "o"),
    "gente": ("d͡ʒ", "ɛ", "n", "t", "e"),
    "niente": ("n", "j", "ɛ", "n", "t", "e"),
    "insieme": ("i", "n", "s", "j", "ɛ", "m", "e"),
    "sedia": ("s", "ɛ", "d", "j", "a"),
    "strada": ("s", "t", "r", "a", "d", "a"),
    "farmacia": ("f", "a", "r", "m", "a", "t͡ʃ", "i", "a"),
    # hiatus i before the stressed vowel (no glide)
    "cliente": ("k", "l", "i", "ˈɛ", "n", "t", "e"),
    "clienti": ("k", "l", "i", "ˈɛ", "n", "t", "i"),
    "polizia": ("p", "o", "l", "i", "t͡s", "i", "a"),
    "zio": ("t͡s", "i", "o"),
    "zia": ("t͡s", "i", "a"),
    "compagnia": ("k", "o", "m", "p", "a", "ɲ", "i", "a"),
    "scienza": ("ʃ", "ɛ", "n", "t͡s", "a"),
    "parola": ("p", "a", "r", "ɔ", "l", "a"),
    "sempre": ("s", "ɛ", "m", "p", "r", "e"),
    "adesso": ("a", "d", "ɛ", "s", "s", "o"),
    "gnocchi": ("ɲ", "ɔ", "k", "k", "i"),
    "due": ("d", "u", "e"),
    # pre-stressed entries (stress_nth_vowel_from_end is a no-op when a
    # mark is already present)
    "autobus": ("ˈa", "u", "t", "o", "b", "u", "s"),
    # interior falling au-diphthongs (vs the paura/baule hiatus default)
    "pausa": ("p", "ˈa", "u", "z", "a"),
    "causa": ("k", "ˈa", "u", "z", "a"),
    "laurea": ("l", "ˈa", "u", "r", "e", "a"),
    "oceano": ("o", "t͡ʃ", "ˈɛ", "a", "n", "o"),
    # English loans
    "jeans": ("d͡ʒ", "ˈi", "n", "s"),
    "weekend": ("w", "ˈi", "k", "ɛ", "n", "d"),
    "yogurt": ("j", "ˈɔ", "ɡ", "u", "r", "t"),
    "email": ("i", "m", "ˈɛ", "i", "l"),
    "software": ("s", "ˈɔ", "f", "t", "w", "e", "r"),
    "smartphone": ("s", "m", "a", "r", "t", "f", "ˈo", "n"),
    "google": ("ɡ", "ˈu", "ɡ", "o", "l"),
    "youtube": ("j", "u", "t", "ˈu", "b"),
    "computer": ("k", "o", "m", "p", "j", "ˈu", "t", "e", "r"),
    "online": ("o", "n", "l", "ˈa", "j", "n"),
    "aereo": ("a", "ˈɛ", "r", "e", "o"),
    "aerei": ("a", "ˈɛ", "r", "e", "i"),
    "nord": ("n", "ˈɔ", "r", "d"),
    # apocopated titles keep final stress (signor Verdi [siɲˈɲor])
    "signor": ("s", "i", "ɲ", "ˈo", "r"),
    "dottor": ("d", "o", "t", "t", "ˈo", "r"),
    "professor": ("p", "r", "o", "f", "e", "s", "s", "ˈo", "r"),
    "sud": ("s", "ˈu", "d"),
}

# Proclitic function words: articles, prepositions (simple and
# articulated), clitic pronouns, common conjunctions.  The riccardo_fasol
# fixtures show gruut leaves these without a stress id ("da", "dove",
# "il", "di", "un'altra" all unmarked) — a stressed article would feed
# the voice a pattern it never saw on these words.
_UNSTRESSED = frozenset("""
il la le lo i gli un a e ed o in con su per tra fra se che ma ne
si mi ti ci vi li
al allo alla ai agli alle dal dallo dalla dai dagli dalle
del dello della dei degli delle nel nello nella nei negli nelle
sul sullo sulla sui sugli sulle col coi
""".split())

# Possessives are unstressed AND keep the vowels in hiatus
# (fixture: "il mio aeroscafo" -> m i o, not m j o)
_UNSTRESSED_FORMS: typing.Dict[str, typing.Tuple[str, ...]] = {
    "mio": ("m", "i", "o"), "mia": ("m", "i", "a"),
    "mie": ("m", "i", "e"), "miei": ("m", "j", "ɛ", "i"),
    "tuo": ("t", "u", "o"), "tua": ("t", "u", "a"),
    "tue": ("t", "u", "e"), "tuoi": ("t", "w", "ɔ", "i"),
    "suo": ("s", "u", "o"), "sua": ("s", "u", "a"),
    "sue": ("s", "u", "e"), "suoi": ("s", "w", "ɔ", "i"),
}

# Sdrucciole (antepenult stress) the penult default cannot know, plus
# the -ere infinitives of the second conjugation (all stem-stressed).
_SDRUCCIOLE = frozenset("""
fabbrica fabbriche naviga nevica difficile difficili facile facili
semplice semplici piccolo piccola piccoli piccole zucchero
sabato sabati domenica domeniche musica musiche telefono telefoni
medico medici ospite ospiti macchina macchine automobile automobili
lettera lettere tavolo tavola tavoli tavole napoli camera camere
numero numeri opera opere ordine ordini pagina pagine popolo popoli
secolo secoli simbolo simboli stomaco subito ultimo ultima ultimi
ultime utile utili albero alberi attimo euro genere generi termine
termini pericolo pericoli spettacolo spettacoli giovane giovani
essere prendere vendere scrivere vivere leggere credere chiudere
correre decidere dividere mettere nascere perdere piangere ridere
rompere scendere spendere vincere chiedere rispondere conoscere
crescere
genova esposito mediterraneo adriatico
""".split())

# 3rd-plural present -ano is unstressed (sdrucciola verb forms); listed
# because -ano NOUNS are penult (italiano, divano) so no blanket rule.
# -ono forms are handled by the ending rule in _phonemize_vowel_stress.
_VERB_ANO = frozenset("""
giocano cantano parlano lavorano abitano arrivano portano mangiano
guardano pensano chiamano aspettano cominciano costano passano restano
tornano entrano suonano volano studiano viaggiano ballano cucinano
comprano trovano amano ascoltano camminano desiderano diventano
dimenticano domandano funzionano giravano girano gridano
incontrano insegnano invitano lasciano nuotano pagano preparano
raccontano ricordano salutano sognano sperano telefonano usano
visitano
""".split())


_ELISION_PREFIXES = ("dell'", "nell'", "sull'", "dall'", "all'",
                     "un'", "l'", "d'", "quest'", "sant'")

# -ia endings pronounced as stressed hiatus.  The derivational suffixes
# are productive (biologia, fotografia, pizzeria); the word set covers
# common hiatus nouns outside them.  Stem -eria/-oria words that glide
# (seria, materia, storia) never reach this: they are not listed and
# none ends in a listed suffix.
_IA_HIATUS_SUFFIXES = (
    "logia", "grafia", "nomia", "crazia", "fonia", "patia", "sofia",
    "scopia", "terapia",
)
_IA_HIATUS = frozenset("""
allegria energia malattia magia bugia follia gelosia nostalgia
fantasia poesia cortesia pizzeria birreria libreria galleria lotteria
batteria segreteria periferia osteria gelateria pasticceria
biancheria cartoleria macelleria salumeria trattoria
maria lombardia
""".split())


def _phonemize_vowel_stress(word: str) -> typing.List[str]:
    """Vowel-attached stress, repositioned to the syllable onset by the
    public ``phonemize`` below (the riccardo_fasol voice was trained
    with gruut's onset-position stress ids — see shift_stress_to_onset)."""
    w = word.lower().strip()
    if not w:
        return []
    hit = _UNSTRESSED_FORMS.get(w)
    if hit is not None:
        return list(hit)
    if w in _UNSTRESSED:
        return apply_rules(w, _RULES, _context)
    # elision: the prefix is unstressed, the host word keeps its own
    # stress pattern (l'autobus -> l + ˈautobus)
    for pre in _ELISION_PREFIXES:
        if w.startswith(pre) and len(w) > len(pre):
            head = apply_rules(pre[:-1], _RULES, _context)
            return head + _phonemize_vowel_stress(w[len(pre):])
    # number compounds in -sei keep the final diphthong stressed
    # (ventisei [ventiˈzɛj]); the penult count would land on -ti-
    if w.endswith("sei") and len(w) > 3:
        head = apply_rules(w[:-3], _RULES, _context)
        s = "z" if head and head[-1] in VOWELS else "s"
        return head + [s, "ˈɛ", "j"]
    # -esimo words are sdrucciole with the suffix vowel stressed:
    # numeral ordinals take open è (ventèsimo, centèsimo, undicèsimo —
    # Treccani/DOP), noun formations closed é (battésimo, umanésimo)
    if len(w) > 6 and w[-5:-1] == "esim" and w[-1] in "oaie":
        stem = w[:-5]
        numeral = stem.endswith((
            "un", "du", "tre", "quattr", "cinqu", "sei", "sett", "ott",
            "nov", "dic", "vent", "trent", "quarant", "cinquant",
            "sessant", "settant", "ottant", "novant", "cent", "mill",
            "milion", "miliard",
        ))
        # walk up to and including the suffix e so soft-c context holds
        # (undicesimo [undiˈt͡ʃɛzimo]), then retint the suffix vowel
        head = apply_rules_span(w, 0, len(w) - 4, _RULES, _context)
        if head and head[-1] == "e" and numeral:
            head[-1] = "ɛ"
        phon = head + ["z", "i", "m", w[-1]]
        return stress_nth_vowel_from_end(phon, VOWELS, n=3)
    # Greek/abstract and shop -ia suffixes are stressed hiatus [ˈi a]
    # (economia, energia, pizzeria); plain -ia words glide (storia,
    # grazia) and take the regular penult path
    if w.endswith("ia") and len(w) > 4 and (
        any(w.endswith(s) for s in _IA_HIATUS_SUFFIXES) or w in _IA_HIATUS
    ):
        head = apply_rules_span(w, 0, len(w) - 2, _RULES, _context)
        return head + ["ˈi", "a"]
    n = 3 if (w in _SDRUCCIOLE or w in _VERB_ANO or (
        w.endswith("ono") and len(w) > 3
    ) or (
        # imperfetto/passato-remoto/conditional 3pl are sdrucciole:
        # parlAvano, prendEvano, parlArono, prenderEbbero — length ≥7
        # keeps the divano-class nouns on the penult default; the short
        # dare/stare imperfetti are listed exceptions
        len(w) >= 7
        and w.endswith(("avano", "evano", "ivano", "arono", "erono",
                        "irono"))
    ) or (
        len(w) >= 6 and w.endswith("ebbero")
    ) or w in ("davano", "erano")) else 2
    hit = _EXCEPTIONS.get(w)
    if hit is not None:
        return stress_nth_vowel_from_end(list(hit), VOWELS, n=n)
    accent_pos = next((i for i, c in enumerate(w) if c in _ACCENTED), None)
    if accent_pos is not None:
        # both halves walk the FULL (accent-stripped) word so boundary
        # context survives ("già": gi+à is one soft-g unit).  The walk
        # must see the BASE letter at the accent (può: the uo-diphthong
        # rule checks for literal 'o'; ciò: the soft-c marker checks
        # nxt in 'aou') — only the emitted stressed symbol carries the
        # open ɛ/ɔ quality
        stressed = _ACCENTED[w[accent_pos]]
        plain = "".join(
            (_BASE.get(c, c) if i == accent_pos else _ACCENTED.get(c, c))
            for i, c in enumerate(w)
        )
        before = apply_rules_span(plain, 0, accent_pos, _RULES, _context)
        rest = ["ˈ" + stressed] + apply_rules_span(
            plain, accent_pos + 1, len(plain), _RULES, _context
        )
        # a rule that consumed PAST the accent (gi+à, qu+ò) already
        # emitted the base vowel; its quality/stress is in `rest`
        return before + rest
    phonemes = apply_rules(w, _RULES, _context)
    # word-initial au- is a falling diphthong (auto, aumentare): its u
    # is a vowel symbol but not a syllable nucleus for the penult count.
    # Interior au stays two nuclei (paura, baule are hiatus); diphthong
    # interiors (pausa, causa, laurea) are _EXCEPTIONS.
    exclude = (
        (1,)
        if len(phonemes) >= 2 and phonemes[0] == "a" and phonemes[1] == "u"
        else ()
    )
    return stress_nth_vowel_from_end(
        phonemes, VOWELS, n=n, exclude_positions=exclude
    )


# Italian letter names (spell-out / ALL-CAPS initialisms), unstressed
_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "a": ["a"], "b": ["b", "i"], "c": ["t͡ʃ", "i"], "d": ["d", "i"],
    "e": ["e"], "f": ["ɛ", "f", "f", "e"], "g": ["d͡ʒ", "i"],
    "h": ["a", "k", "k", "a"], "i": ["i"],
    "j": ["i", "l", "u", "n", "ɡ", "a"], "k": ["k", "a", "p", "p", "a"],
    "l": ["ɛ", "l", "l", "e"], "m": ["ɛ", "m", "m", "e"],
    "n": ["ɛ", "n", "n", "e"], "o": ["o"], "p": ["p", "i"],
    "q": ["k", "u"], "r": ["ɛ", "r", "r", "e"],
    "s": ["ɛ", "s", "s", "e"], "t": ["t", "i"], "u": ["u"],
    "v": ["v", "u"], "w": ["d", "o", "p", "p", "j", "a", "v", "u"],
    "x": ["i", "k", "s"], "y": ["i", "p", "s", "i", "l", "o", "n"],
    "z": ["d͡z", "ɛ", "t", "a"],
}


def phonemize(word: str) -> typing.List[str]:
    """Italian word -> IPA with gruut's onset-position stress ids
    (the it-it voices' test_phonemes.csv put ˈ before the syllable's
    onset cluster: "vieni" -> ˈ v j ɛ n i, not v j ˈɛ n i)."""
    if word.isalpha() and (
        (
            word.isupper()
            and 2 <= len(word) <= 6
            and (len(word) <= 3 or not acronym_readable(word.lower()))
        )
        or len(word) == 1
    ) and word.lower() not in _EXCEPTIONS and all(
        c in _LETTER_NAMES for c in word.lower()
    ):
        return spell_letters(word.lower(), _LETTER_NAMES)
    return shift_stress_to_onset(_phonemize_vowel_stress(word), VOWELS)
