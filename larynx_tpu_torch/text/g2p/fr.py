# Copied from larynx_tpu/text/g2p/fr.py; only the package name in its imports and the reference path in a comment differ.
"""French G2P — rule engine + function-word/irregular lexicon.

Inventory (local/fr-fr/*/phonemes.txt): a b d e f i j k l m n o p s t u v w
y z ø ŋ œ œ̃ ɑ̃ ɔ ɔ̃ ə ɛ ɛ̃ ɡ ɥ ɲ ʁ ʃ ʒ + ˈ ˌ.  No stress marks are
emitted (see ``phonemize``): gruut-fr produced none for the released
voices, French having phrase-final prosodic stress only.

The reference reached French through gruut's fr lexicon
(larynx/__init__.py:71-73); here an ordered-rule engine
covers the regular orthography (silent finals, nasal vowels, digraphs,
glides, -er/-ez verb endings, closed-syllable e) and ``_EXCEPTIONS``
carries the function words and irregulars whose spelling lies
(est, femme, monsieur, six, …).  tests/golden/fr_pronunciations.tsv
pins 100+ hand-verified words.
"""

import re
import typing

from larynx_tpu_torch.text.g2p.rules import apply_rules, spell_letters

VOWELS = {"a", "e", "i", "o", "u", "y", "ø", "œ", "œ̃", "ɑ̃", "ɔ", "ɔ̃", "ɛ", "ɛ̃"}

_RULES = [
    ("eaux", "o"), ("eau", "o"),
    ("aux", "o"), ("eux", "ø"),
    ("oin", "w ɛ̃"),
    ("ain", "ɛ̃"), ("aim", "ɛ̃"), ("ein", "ɛ̃"),
    ("ien", "j ɛ̃"),
    ("tion", "s j ɔ̃"),
    ("ailler", "a j e"), ("eiller", "ɛ j e"), ("ouiller", "u j e"),
    ("aillez", "a j e"), ("eillez", "ɛ j e"), ("ouillez", "u j e"),
    ("aillons", "a j ɔ̃"), ("eillons", "ɛ j ɔ̃"), ("ouillons", "u j ɔ̃"),
    ("aillais", "a j ɛ"), ("aillait", "a j ɛ"),
    ("euiller", "œ j e"), ("iller", "i j e"),
    ("eilli", "ɛ j i"),
    ("eille", "ɛ j"), ("eil", "ɛ j"),
    ("aille", "a j"), ("ail", "a j"),
    ("euille", "œ j"), ("euil", "œ j"), ("ueill", "œ j"), ("ueil", "œ j"),
    ("ouille", "u j"), ("ouil", "u j"),
    ("ill", "i j"),
    ("ou", "u"), ("où", "u"), ("oû", "u"),
    ("oi", "w a"), ("oy", "w a j"),
    ("au", "o"),
    ("ai", "ɛ"), ("ei", "ɛ"), ("ay", "ɛ j"),
    ("eû", "ø"),
    ("eu", "ø"), ("œu", "œ"), ("œ", "œ"), ("oeu", "œ"), ("oe", "œ"),
    ("uin", "ɥ ɛ̃"), ("uill", "ɥ i j"), ("ui", "ɥ i"),
    ("aî", "ɛ"),
    ("ch", "ʃ"),
    ("gn", "ɲ"),
    ("ph", "f"),
    ("qu", "k"), ("q", "k"),
    ("th", "t"),
    ("ç", "s"),
    ("é", "e"), ("è", "ɛ"), ("ê", "ɛ"), ("ë", "ɛ"),
    ("à", "a"), ("â", "a"),
    ("î", "i"), ("ï", "i"),
    ("ô", "o"),
    ("û", "y"), ("ù", "y"),
    ("a", "a"), ("b", "b"), ("d", "d"), ("e", "ə"), ("f", "f"),
    ("h", ""),
    ("i", "i"), ("j", "ʒ"), ("k", "k"), ("l", "l"), ("m", "m"),
    ("n", "n"), ("o", "ɔ"), ("p", "p"), ("r", "ʁ"), ("s", "s"),
    ("t", "t"), ("u", "y"), ("v", "v"), ("w", "w"), ("x", "k s"),
    ("y", "i"), ("z", "z"),
]

_SILENT_FINALS = set("dstxzpg")
_ORAL_VOWEL_LETTERS = "aeiouyéèêëàâîïôûù"
_CONSONANTS = set("bcdfgjklmnpqrstvwxz")
_DOUBLE_MAP = {
    "b": "b", "d": "d", "f": "f", "l": "l", "m": "m", "n": "n",
    "p": "p", "r": "ʁ", "s": "s", "t": "t", "v": "v", "z": "z",
}


def _context(word: str, i: int):
    ch = word[i]
    nxt = word[i + 1] if i + 1 < len(word) else ""
    nxt2 = word[i + 2] if i + 2 < len(word) else ""
    prev = word[i - 1] if i > 0 else ""

    # Greek clusters: psych- is [psik] even before a vowel (psychologue,
    # psychiatre); ch before a consonant is [k] (technologie, chlore,
    # chrétien, arachnide) — the default ch = [ʃ] only holds prevocalic
    if i == 0 and word.startswith("psych"):
        return 5, ["p", "s", "i", "k"]
    if word.startswith("ch", i) and nxt2 in _CONSONANTS:
        return 2, ["k"]
    # -eilleux/-eilleuse adjectives: the eill glide + the -eux suffix
    # (merveilleux [mɛʁvɛjø]) — longest-match "eille" would otherwise
    # strand "ux" as [y].  After the gu/cu digraph the nucleus is œ
    # (orgueilleux [ɔʁɡœjø], as in accueil/orgueil)
    if word.startswith("eilleu", i) and word[i + 6 : i + 7] in ("x", "s"):
        nucleus = "œ" if i > 0 and word[i - 1] == "u" else "ɛ"
        return 6, [nucleus, "j", "ø"]
    # e before the [k]-reading ch cluster sits in a closed syllable
    # (technologie [tɛknɔlɔʒi]) — the open-syllable schwa must not fire
    if (
        ch == "e"
        and word.startswith("ch", i + 1)
        and word[i + 3 : i + 4] in _CONSONANTS
    ):
        return 1, ["ɛ"]

    # ain/aim/ein/oin/uin followed by a vowel are NOT nasal — the n/m
    # starts the next syllable (semaine, vraiment, moine, ruine): emit
    # the oral digraph reading and leave the n/m to its own rule.  The
    # plain trigram rules below only see the coda cases.
    if nxt2 and nxt2 in "nm" and i + 3 < len(word) and word[
        i + 3
    ] in _ORAL_VOWEL_LETTERS:
        tri = word[i : i + 3]
        oral = {
            "ain": ["ɛ"], "aim": ["ɛ"], "ein": ["ɛ"],
            "oin": ["w", "a"], "uin": ["ɥ", "i"],
        }.get(tri)
        if oral is not None:
            return 2, oral

    # eu in a closed syllable opens to œ (jeune, seul, peur, neuf,
    # veuve, beurre, heurter); it stays ø before t/s sounds (meute,
    # neutre, chanteuse) and before silent finals (peut); -eux has its
    # own rule.  n/m only close the syllable with a following mute e
    # (jeune) — a bare coda n is the nasal (à jeun).
    if word.startswith("eu", i) and not word.startswith("eux", i):
        rest = word[i + 2:]
        if rest and rest[0] in _CONSONANTS and rest[0] not in "st":
            if rest[0] in "nm":
                closed = rest in (rest[0] + "e", rest[0] + "es")
            elif len(rest) == 1:
                closed = rest[0] not in _SILENT_FINALS
            else:
                closed = (
                    rest in (rest[0] + "e", rest[0] + "es")
                    or rest[1] in _CONSONANTS
                )
            if closed:
                return 2, ["œ"]
    # entre- prefix keeps its schwa (entreprise, entretien) — the
    # closed-syllable e rule would otherwise read [ɛ]
    if i == 0 and word.startswith("entre") and len(word) > 6:
        return 5, ["ɑ̃", "t", "ʁ", "ə"]

    # digraphs the single-letter context rules must not shadow
    if word.startswith("ch", i):
        return 2, ["ʃ"]
    if word.startswith("gn", i) and i > 0:
        return 2, ["ɲ"]
    # s + tion keeps the [t] (question)
    if word.startswith("tion", i) and i > 0 and word[i - 1] == "s":
        return 4, ["t", "j", "ɔ̃"]
    # place-name suffix -bourg keeps its g silent (Strasbourg,
    # Luxembourg, Cherbourg)
    if word.startswith("bourg", i) and i > 0 and i + 5 == len(word):
        return 5, ["b", "u", "ʁ"]
    # word-final -ien(s) is [j ɛ̃] (bien, ancien); elsewhere i-glide +
    # nasal handling yields [j ɑ̃] (patient, orient)
    if word.startswith("ien", i) and word[i + 3 :] in ("", "s"):
        return len(word) - i, ["j", "ɛ̃"]
    # word-final -en after é/y is also [ɛ̃] (européen, moyen, citoyen)
    if (
        word.startswith("en", i)
        and word[i + 2 :] in ("", "s")
        and prev  # NB: '' is "in" every string
        and prev in "éy"
    ):
        return len(word) - i, ["ɛ̃"]
    # -emment adverbs say [a m ɑ̃] (évidemment, récemment, prudemment)
    if word.startswith("emment", i) and i > 0 and i + 6 == len(word):
        return 6, ["a", "m", "ɑ̃"]
    # English loan digraph sh -> [ʃ] (short, flash) — not across the
    # dés+h morpheme seam (déshabiller is [dez...])
    if word.startswith("sh", i) and word[:i] not in ("dé", "de", "tran"):
        return 2, ["ʃ"]
    # English loan final -ing is [i ŋ] (parking, camping) — native
    # vowel+ing finals are the nasal [ɛ̃] (poing, coing, shampooing)
    if (
        word.startswith("ing", i)
        and i + 3 == len(word)
        and i >= 3
        and prev not in "aeiouyéè"
    ):
        return 3, ["i", "ŋ"]

    # nasal vowels: vowel + n/m in coda (followed by consonant or word
    # end; NOT by a vowel, h, or a doubled n/m).  "" would count as a
    # member of any probe string, so the word-end case is explicit.
    def _coda(blockers: str) -> bool:
        return nxt2 == "" or (nxt2 not in blockers and nxt2 != nxt)

    if ch in "ao" and nxt and nxt in "nm" and _coda(_ORAL_VOWEL_LETTERS + "h"):
        return 2, ["ɑ̃"] if ch == "a" else ["ɔ̃"]
    if ch == "e" and nxt and nxt in "nm" and _coda(_ORAL_VOWEL_LETTERS):
        return 2, ["ɑ̃"]
    if ch == "i" and nxt and nxt in "nm" and _coda(_ORAL_VOWEL_LETTERS):
        return 2, ["ɛ̃"]
    if ch == "u" and nxt == "n" and (
        nxt2 == "" or (nxt2 not in _ORAL_VOWEL_LETTERS and nxt2 != "n")
    ):
        return 2, ["œ̃"]

    if ch == "c":
        if nxt == "q":
            return 1, []  # cq is one [k] (Jacques, acquérir)
        if nxt and nxt in "eiyéè":
            return 1, ["s"]
        if nxt == "c" and not (nxt2 and nxt2 in "eiyéè"):
            return 2, ["k"]
        return 1, ["k"]
    if ch == "g":
        # softener e: ge before a back vowel is [ʒ] with the e mute
        # (mangeons, mangeait, pigeon, Georges)
        if nxt == "e" and nxt2 and nxt2 in "aou":
            return 2, ["ʒ"]
        if nxt and nxt in "eiyéè":
            return 1, ["ʒ"]
        if nxt == "u" and nxt2 and nxt2 in "eiyéè":
            # g + ueil: the u belongs to the [œ j] nucleus (orgueil),
            # not to the silent-u digraph
            if word.startswith("ueil", i + 1):
                return 1, ["ɡ"]
            return 2, ["ɡ"]  # silent u
        return 1, ["ɡ"]
    if (
        ch == "s"
        and i > 0
        and word[i - 1] in "aeiouyéè"
        and nxt
        and nxt in "aeiouyéèh"  # mute h keeps s intervocalic (déshabiller)
    ):
        return 1, ["z"]  # intervocalic s
    # doubled consonants collapse to one sound (c/g doubles are left to
    # their context rules above: "accent" needs [k s])
    if nxt == ch and ch in _DOUBLE_MAP:
        return 2, [_DOUBLE_MAP[ch]]
    # verb/noun endings -er, -ez say [e] with a silent consonant
    if i + 2 == len(word) and i >= 2 and word[i:] in ("er", "ez"):
        return 2, ["e"]
    # closed-syllable e (followed by a coda consonant): mer, avec, cette
    if (
        ch == "e"
        and nxt in _CONSONANTS
        and (nxt2 == "" or nxt2 in _CONSONANTS)
        and not (nxt in _SILENT_FINALS and nxt2 == "")
    ):
        return 1, ["ɛ"]
    # sc before front vowels is [s] (science, scène)
    if word.startswith("sc", i) and nxt2 and nxt2 in "eiyéè":
        return 2, ["s"]
    # word-final -et says [ɛ] (juillet, violet; "et" itself is a lexicon
    # entry)
    if i + 2 == len(word) and i >= 1 and word[i:] == "et":
        return 2, ["ɛ"]
    # plural/verbal -es is silent (tables, sciences); the e is NOT schwa
    if (
        word.endswith("es")
        and i == len(word) - 2
        and len(word) > 3
        and ch == "e"
    ):
        return 2, []
    # o before a final [z] syllable is close [o] (chose, rose)
    if ch == "o" and nxt in "sz" and nxt2 == "e" and i + 3 == len(word):
        return 1, ["o"]
    # i before a vowel glides to j (premier, bien is caught earlier) —
    # except before a FINAL mute e (pharmacie, vie: the -ie is [i])
    if (
        ch == "i"
        and nxt
        and nxt in "aeouéèê"
        and i > 0
        and not (nxt == "e" and i + 2 == len(word))
        and not (word.endswith("es") and i + 3 == len(word))
    ):
        return 1, ["j"]
    # word-final -o is close [o] (vélo, piano, radio)
    if ch == "o" and i + 1 == len(word) and len(word) > 1:
        return 1, ["o"]
    # o closes before a final silent coda (mot, gros, trop, mots)
    if (
        ch == "o"
        and word[i + 1 :]
        and word[i + 1 :] in ("t", "ts", "s", "p", "ps", "d", "ds", "c", "cs")
    ):
        return 1, ["o"]
    # final silent two-letter clusters: plural of silent-final words
    # (billets, comprends, champs, longs — gruut: "plats" -> p l a)
    if (
        i + 2 == len(word)
        and len(word) > 3
        and ch in "dtpgc"
        and word[i + 1] == "s"
    ):
        return 2, []
    # final silent letters
    if i + 1 == len(word) and len(word) > 1:
        if ch in _SILENT_FINALS:
            return 1, []
        if ch == "e" and len(word) > 2:
            return 1, []  # mute final e
        if word.endswith("es") and i == len(word) - 2 and len(word) > 3:
            return 2, []
    return None


# Function words and irregulars the rules cannot derive.  Hand-verified
# against standard French (metropolitan, the gruut fr-fr convention).
_EXCEPTIONS: typing.Dict[str, typing.Tuple[str, ...]] = {
    # Latin loan: final -us is [ys] with the s sounded
    "celsius": ("s", "ɛ", "l", "s", "j", "y", "s"),
    # past participle of avoir: feminine eue/eues stay [y]
    "eue": ("y",),
    "eues": ("y",),
    # silent final consonant clusters the rules cannot know (lexical)
    "franc": ("f", "ʁ", "ɑ̃"),
    "francs": ("f", "ʁ", "ɑ̃"),
    "flanc": ("f", "l", "ɑ̃"),
    "flancs": ("f", "l", "ɑ̃"),
    "porc": ("p", "ɔ", "ʁ"),
    "porcs": ("p", "ɔ", "ʁ"),
    "clerc": ("k", "l", "ɛ", "ʁ"),
    "clercs": ("k", "l", "ɛ", "ʁ"),
    "respect": ("ʁ", "ɛ", "s", "p", "ɛ"),
    "respects": ("ʁ", "ɛ", "s", "p", "ɛ"),
    "suspect": ("s", "y", "s", "p", "ɛ"),
    "suspects": ("s", "y", "s", "p", "ɛ"),
    "aspect": ("a", "s", "p", "ɛ"),
    "aspects": ("a", "s", "p", "ɛ"),
    "instinct": ("ɛ̃", "s", "t", "ɛ̃"),
    "instincts": ("ɛ̃", "s", "t", "ɛ̃"),
    "distinct": ("d", "i", "s", "t", "ɛ̃"),
    "distincts": ("d", "i", "s", "t", "ɛ̃"),
    "doigt": ("d", "w", "a"),
    "doigts": ("d", "w", "a"),
    # irregular plurals: the f of œuf/bœuf falls silent
    "œufs": ("ø",),
    "bœufs": ("b", "ø"),
    "sculpter": ("s", "k", "y", "l", "t", "e"),
    "sculpté": ("s", "k", "y", "l", "t", "e"),
    "sculptée": ("s", "k", "y", "l", "t", "e"),
    "paysan": ("p", "e", "i", "z", "ɑ̃"),
    "paysanne": ("p", "e", "i", "z", "a", "n"),
    "paysans": ("p", "e", "i", "z", "ɑ̃"),
    # English loans
    "clown": ("k", "l", "u", "n"),
    "clowns": ("k", "l", "u", "n"),
    "interview": ("ɛ̃", "t", "ɛ", "ʁ", "v", "j", "u"),
    "interviews": ("ɛ̃", "t", "ɛ", "ʁ", "v", "j", "u"),
    "puzzle": ("p", "œ", "z", "l"),
    "shampooing": ("ʃ", "ɑ̃", "p", "w", "ɛ̃"),
    "jazz": ("d", "ʒ", "a", "z"),
    "google": ("ɡ", "u", "ɡ", "œ", "l"),
    # place names the rules cannot see
    "lille": ("l", "i", "l"),
    "strasbourg": ("s", "t", "ʁ", "a", "z", "b", "u", "ʁ"),
    "états-unis": ("e", "t", "a", "z", "y", "n", "i"),
    "youtube": ("j", "u", "t", "y", "b"),
    "podcast": ("p", "ɔ", "d", "k", "a", "s", "t"),
    "smartphone": ("s", "m", "a", "ʁ", "t", "f", "ɔ", "n"),
    "online": ("ɔ", "n", "l", "a", "j", "n"),
    "le": ("l", "ə"),
    "les": ("l", "e"),
    "des": ("d", "e"),
    "mes": ("m", "e"),
    "tes": ("t", "e"),
    "ses": ("s", "e"),
    "ces": ("s", "e"),
    "et": ("e",),
    "est": ("ɛ",),
    "es": ("ɛ",),
    "que": ("k", "ə"),
    "qu'il": ("k", "i", "l"),
    "qu'elle": ("k", "ɛ", "l"),
    "femme": ("f", "a", "m"),
    "femmes": ("f", "a", "m"),
    "monsieur": ("m", "ə", "s", "j", "ø"),
    "messieurs": ("m", "e", "s", "j", "ø"),
    "temps": ("t", "ɑ̃"),
    "printemps": ("p", "ʁ", "ɛ̃", "t", "ɑ̃"),
    "corps": ("k", "ɔ", "ʁ"),
    "fils": ("f", "i", "s"),
    "pays": ("p", "e", "i"),
    "paysage": ("p", "e", "i", "z", "a", "ʒ"),
    "hier": ("i", "ɛ", "ʁ"),
    "yeux": ("j", "ø"),
    "oeil": ("œ", "j"),
    "œil": ("œ", "j"),
    "aujourd'hui": ("o", "ʒ", "u", "ʁ", "d", "ɥ", "i"),
    # hyphen liaison: the t of peut sounds (checked before "-" splitting)
    "peut-être": ("p", "ø", "t", "ɛ", "t", "ʁ"),
    # derivatives keep the base's closed-syllable œ
    "jeunesse": ("ʒ", "œ", "n", "ɛ", "s"),
    "seulement": ("s", "œ", "l", "m", "ɑ̃"),
    "six": ("s", "i", "s"),
    "dix": ("d", "i", "s"),
    "huit": ("ɥ", "i", "t"),
    "neuf": ("n", "œ", "f"),
    "vingt": ("v", "ɛ̃"),
    "second": ("s", "ə", "ɡ", "ɔ̃"),
    "seconde": ("s", "ə", "ɡ", "ɔ̃", "d"),
    "blanc": ("b", "l", "ɑ̃"),
    "blancs": ("b", "l", "ɑ̃"),
    "estomac": ("ɛ", "s", "t", "ɔ", "m", "a"),
    "tabac": ("t", "a", "b", "a"),
    "ville": ("v", "i", "l"),
    "villes": ("v", "i", "l"),
    "village": ("v", "i", "l", "a", "ʒ"),
    "mille": ("m", "i", "l"),
    "tranquille": ("t", "ʁ", "ɑ̃", "k", "i", "l"),
    "oui": ("w", "i"),
    "sept": ("s", "ɛ", "t"),
    "dix-sept": ("d", "i", "s", "ɛ", "t"),
    "dix-huit": ("d", "i", "z", "ɥ", "i", "t"),
    "dix-neuf": ("d", "i", "z", "n", "œ", "f"),
    "soixante": ("s", "w", "a", "s", "ɑ̃", "t"),
    "soixante-dix": ("s", "w", "a", "s", "ɑ̃", "t", "d", "i", "s"),
    "quatre-vingt": ("k", "a", "t", "ʁ", "ə", "v", "ɛ̃"),
    "quatre-vingts": ("k", "a", "t", "ʁ", "ə", "v", "ɛ̃"),
    "quatre-vingt-dix": ("k", "a", "t", "ʁ", "ə", "v", "ɛ̃", "d", "i", "s"),
    "million": ("m", "i", "l", "j", "ɔ̃"),
    "millions": ("m", "i", "l", "j", "ɔ̃"),
    "milliard": ("m", "i", "l", "j", "a", "ʁ"),
    "milliards": ("m", "i", "l", "j", "a", "ʁ"),
    "week-end": ("w", "i", "k", "ɛ", "n", "d"),
    "email": ("i", "m", "ɛ", "l"),
    "internet": ("ɛ̃", "t", "ɛ", "ʁ", "n", "ɛ", "t"),
    "football": ("f", "u", "t", "b", "o", "l"),
    "tennis": ("t", "e", "n", "i", "s"),
    "août": ("u", "t"),
    "monde": ("m", "ɔ̃", "d"),
    "grande": ("ɡ", "ʁ", "ɑ̃", "d"),
    "examen": ("ɛ", "ɡ", "z", "a", "m", "ɛ̃"),
    "ennui": ("ɑ̃", "n", "ɥ", "i"),
    "ennemi": ("ɛ", "n", "m", "i"),
    "solennel": ("s", "ɔ", "l", "a", "n", "ɛ", "l"),
    "gentil": ("ʒ", "ɑ̃", "t", "i"),
    "outil": ("u", "t", "i"),
    "fusil": ("f", "y", "z", "i"),
    "sourcil": ("s", "u", "ʁ", "s", "i"),
    "clef": ("k", "l", "e"),
    "clé": ("k", "l", "e"),
    "pied": ("p", "j", "e"),
    "pieds": ("p", "j", "e"),
    "assied": ("a", "s", "j", "e"),
    "nez": ("n", "e"),
    "chez": ("ʃ", "e"),
    # initial ex- before a vowel is [ɛɡz]
    "examen": ("ɛ", "ɡ", "z", "a", "m", "ɛ̃"),
    "examens": ("ɛ", "ɡ", "z", "a", "m", "ɛ̃"),
    "exemple": ("ɛ", "ɡ", "z", "ɑ̃", "p", "l"),
    "exemples": ("ɛ", "ɡ", "z", "ɑ̃", "p", "l"),
    "exercice": ("ɛ", "ɡ", "z", "ɛ", "ʁ", "s", "i", "s"),
    "exercices": ("ɛ", "ɡ", "z", "ɛ", "ʁ", "s", "i", "s"),
    "exact": ("ɛ", "ɡ", "z", "a", "k", "t"),
    "exactement": ("ɛ", "ɡ", "z", "a", "k", "t", "ə", "m", "ɑ̃"),
    "existe": ("ɛ", "ɡ", "z", "i", "s", "t"),
    "exister": ("ɛ", "ɡ", "z", "i", "s", "t", "e"),
    # mp-cluster with silent p
    "compte": ("k", "ɔ̃", "t"),
    "comptes": ("k", "ɔ̃", "t"),
    "compter": ("k", "ɔ̃", "t", "e"),
    "comptent": ("k", "ɔ̃", "t"),
    "sculpture": ("s", "k", "y", "l", "t", "y", "ʁ"),
    "bus": ("b", "y", "s"),
    "euro": ("ø", "ʁ", "o"),
    "euros": ("ø", "ʁ", "o"),
    "sixième": ("s", "i", "z", "j", "ɛ", "m"),
    "dixième": ("d", "i", "z", "j", "ɛ", "m"),
    # silent g: vingtième [vɛ̃tjɛm]
    "vingtième": ("v", "ɛ̃", "t", "j", "ɛ", "m"),
    "vingtièmes": ("v", "ɛ̃", "t", "j", "ɛ", "m"),
    "hier": ("j", "ɛ", "ʁ"),
    "mesdames": ("m", "e", "d", "a", "m"),
    # fais- conjugation has the irregular schwa (nous faisons [fəzɔ̃])
    "faisons": ("f", "ə", "z", "ɔ̃"),
    "faisait": ("f", "ə", "z", "ɛ"),
    "faisais": ("f", "ə", "z", "ɛ"),
    "faisaient": ("f", "ə", "z", "ɛ"),
    "faisant": ("f", "ə", "z", "ɑ̃"),
    "lyon": ("l", "j", "ɔ̃"),
    "manuel": ("m", "a", "n", "ɥ", "ɛ", "l"),
    "manuels": ("m", "a", "n", "ɥ", "ɛ", "l"),
    "manuelle": ("m", "a", "n", "ɥ", "ɛ", "l"),
    # subject-inversion forms keep the liaison t
    "est-il": ("ɛ", "t", "i", "l"),
    "est-elle": ("ɛ", "t", "ɛ", "l"),
    "est-on": ("ɛ", "t", "ɔ̃"),
    "est-ce": ("ɛ", "s"),
    "vingts": ("v", "ɛ̃"),
    "eux": ("ø",),
    "deuxième": ("d", "ø", "z", "j", "ɛ", "m"),
    "sens": ("s", "ɑ̃", "s"),
    "tous": ("t", "u", "s"),
    "plus": ("p", "l", "y", "s"),
    "fives": ("f", "i", "v"),
    "jeanne": ("ʒ", "a", "n"),
    "jean": ("ʒ", "ɑ̃"),
    "caen": ("k", "ɑ̃"),
    "paon": ("p", "ɑ̃"),
    "faon": ("f", "ɑ̃"),
    "taon": ("t", "ɑ̃"),
    "oignon": ("ɔ", "ɲ", "ɔ̃"),
    "poêle": ("p", "w", "a", "l"),
    "moelle": ("m", "w", "a", "l"),
    "soeur": ("s", "œ", "ʁ"),
    "sœur": ("s", "œ", "ʁ"),
    "coeur": ("k", "œ", "ʁ"),
    "cœur": ("k", "œ", "ʁ"),
    "oeuf": ("œ", "f"),
    "œuf": ("œ", "f"),
    "oeufs": ("ø",),
    "boeuf": ("b", "œ", "f"),
    "bœuf": ("b", "œ", "f"),
    "choeur": ("k", "œ", "ʁ"),
    "chœur": ("k", "œ", "ʁ"),
    "chorale": ("k", "ɔ", "ʁ", "a", "l"),
    "chaos": ("k", "a", "o"),
    "écho": ("e", "k", "o"),
    "orchestre": ("ɔ", "ʁ", "k", "ɛ", "s", "t", "ʁ"),
    "technique": ("t", "ɛ", "k", "n", "i", "k"),
    "christ": ("k", "ʁ", "i", "s", "t"),
    "chrétien": ("k", "ʁ", "e", "t", "j", "ɛ̃"),
    "psychologie": ("p", "s", "i", "k", "ɔ", "l", "ɔ", "ʒ", "i"),
    "archéologie": ("a", "ʁ", "k", "e", "ɔ", "l", "ɔ", "ʒ", "i"),
    "été": ("e", "t", "e"),
    "être": ("ɛ", "t", "ʁ"),
    "eut": ("y",),
    "eu": ("y",),
    "eau": ("o",),
    "eaux": ("o",),
    "haut": ("o",),
    "donc": ("d", "ɔ̃", "k"),
    "parce": ("p", "a", "ʁ", "s", "ə"),
    "hiver": ("i", "v", "ɛ", "ʁ"),
    "fer": ("f", "ɛ", "ʁ"),
    "mer": ("m", "ɛ", "ʁ"),
    "amer": ("a", "m", "ɛ", "ʁ"),
    "cher": ("ʃ", "ɛ", "ʁ"),
    "fier": ("f", "j", "ɛ", "ʁ"),
    "super": ("s", "y", "p", "ɛ", "ʁ"),
    "cancer": ("k", "ɑ̃", "s", "ɛ", "ʁ"),
    "albert": ("a", "l", "b", "ɛ", "ʁ"),
    "automne": ("o", "t", "ɔ", "n"),
    "condamner": ("k", "ɔ̃", "d", "a", "n", "e"),
    "baptême": ("b", "a", "t", "ɛ", "m"),
    "compter": ("k", "ɔ̃", "t", "e"),
    "sculpteur": ("s", "k", "y", "l", "t", "œ", "ʁ"),
    "longtemps": ("l", "ɔ̃", "t", "ɑ̃"),
    "moins": ("m", "w", "ɛ̃"),
    "néanmoins": ("n", "e", "ɑ̃", "m", "w", "ɛ̃"),
    "loin": ("l", "w", "ɛ̃"),
    "besoin": ("b", "ə", "z", "w", "ɛ̃"),
    "point": ("p", "w", "ɛ̃"),
    "poing": ("p", "w", "ɛ̃"),
    "coing": ("k", "w", "ɛ̃"),
    "bientôt": ("b", "j", "ɛ̃", "t", "o"),
}


# Third-person-plural verb forms: the written -ent is SILENT (ils
# parlent = [paʁl]), but -ent is also a common nasal noun/adverb ending
# (moment, vraiment) — undecidable without POS context, so the frequent
# verb forms are listed and pronounced as their stem + mute e.
_ENT_VERB_FORMS = frozenset(
    stem + "ent"
    for stem in (
        # -er verbs (3pl = stem of the -e form)
        "parl", "aim", "donn", "chant", "arriv", "demand", "regard",
        "pens", "trouv", "montr", "écout", "habit", "travaill", "jou",
        "mang", "laiss", "pass", "rest", "port", "entr", "sembl",
        "tomb", "gard", "quitt", "cherch", "appell", "commenc",
        "continu", "exist", "manqu", "occup", "présent", "propos",
        "racont", "rappell", "ressembl", "retrouv", "chang", "dans",
        "march", "étudi", "essai", "pai", "envoi", "emploi", "utilis",
        "ajout", "prépar", "form", "pouss", "brill", "coul", "souffl",
        "tourn", "ferm", "lav", "lèv", "jett", "mont", "saut", "vol",
        "nag", "oubli", "tir", "jug", "cass", "attrap", "ramass",
        "dessin", "dîn", "déjeun", "voyag", "visit", "invit", "achet",
        "appuy", "allum", "éteign", "rêv", "pleur", "cri", "souri",
        # irregular stems whose 3pl matches stem + mute e
        "veul", "peuv", "doiv", "prenn", "vienn", "tienn", "comprenn",
        "apprenn", "connaiss", "finiss", "choisiss", "réussiss",
        "fleuriss", "grandiss", "rempliss", "réfléchiss", "nourriss",
        "guériss", "vieilliss", "rougiss", "bâtiss", "obéiss",
        "mett", "permett", "attend", "entend", "répond", "vend",
        "perd", "descend", "viv", "suiv", "écriv", "lis", "dis",
        "part", "sort", "dorm", "serv", "ouvr", "offr", "souffr",
        "croi", "voi", "reçoiv", "sav", "boiv", "ri",
        "naiss", "renaiss", "paraiss", "apparaiss", "disparaiss",
        "cré", "fui", "nettoi", "pay", "essuy", "appui", "ennui",
        "détest", "ador", "remarqu", "expliqu", "indiqu", "critiqu",
    )
)


# Elided clitic prefixes (c'est, j'ai, l'école, qu'il, jusqu'à ...):
# the apostrophe marks a dropped vowel; the prefix keeps its consonant
# value (c' before the elided e is [s]).
_ELISION_PREFIXES: typing.Dict[str, typing.List[str]] = {
    "c": ["s"], "j": ["ʒ"], "l": ["l"], "d": ["d"], "s": ["s"],
    "n": ["n"], "m": ["m"], "t": ["t"], "qu": ["k"],
    "jusqu": ["ʒ", "y", "s", "k"], "lorsqu": ["l", "ɔ", "ʁ", "s", "k"],
    "puisqu": ["p", "ɥ", "i", "s", "k"],
    "quelqu": ["k", "ɛ", "l", "k"],
}

_VOWEL_INITIAL = "aeiouyhéèêëàâîïôûùœæ"


# obligatory liaison: closed-class words whose final consonant sounds
# before a vowel-initial word (les amis [lez], un ami [œ̃n], est ici
# [ɛt]). Keyed word -> (base phonemes, liaison consonant).
_LIAISON = {
    # plural determiners / pronouns / prepositions -> z
    "les": (("l", "e"), "z"), "des": (("d", "e"), "z"),
    "ces": (("s", "e"), "z"), "mes": (("m", "e"), "z"),
    "tes": (("t", "e"), "z"), "ses": (("s", "e"), "z"),
    "nos": (("n", "o"), "z"), "vos": (("v", "o"), "z"),
    "leurs": (("l", "œ", "ʁ"), "z"), "aux": (("o",), "z"),
    "nous": (("n", "u"), "z"), "vous": (("v", "u"), "z"),
    "ils": (("i", "l"), "z"), "elles": (("ɛ", "l"), "z"),
    "dans": (("d", "ɑ̃"), "z"), "chez": (("ʃ", "e"), "z"),
    "sans": (("s", "ɑ̃"), "z"), "très": (("t", "ʁ", "ɛ"), "z"),
    "quelques": (("k", "ɛ", "l", "k", "ə"), "z"),
    "plusieurs": (("p", "l", "y", "z", "j", "œ", "ʁ"), "z"),
    # nasal determiners / adverbs -> n (the nasal vowel stays)
    "un": (("œ̃",), "n"), "mon": (("m", "ɔ̃"), "n"),
    "ton": (("t", "ɔ̃"), "n"), "son": (("s", "ɔ̃"), "n"),
    "on": (("ɔ̃",), "n"), "en": (("ɑ̃",), "n"),
    "bien": (("b", "j", "ɛ̃"), "n"), "rien": (("ʁ", "j", "ɛ̃"), "n"),
    "aucun": (("o", "k", "œ̃"), "n"),
    # verb forms / adverbs -> t
    "est": (("ɛ",), "t"), "sont": (("s", "ɔ̃"), "t"),
    "ont": (("ɔ̃",), "t"), "tout": (("t", "u"), "t"),
    "quand": (("k", "ɑ̃"), "t"), "c'est": (("s", "ɛ"), "t"),
}

# liaison never happens before these despite the initial vowel letter:
# the conjunctions et/ou, oui, onze, and h-aspiré words
_LIAISON_BLOCKED_NEXT = frozenset({
    "et", "ou", "où", "oui", "onze", "onzième",
    # h aspiré
    "haricot", "haricots", "héros", "hasard", "haut", "haute", "hauts",
    "hautes", "honte", "hache", "haine", "hall", "halles", "hamac",
    "hanche", "handicap", "hareng", "harpe", "hibou", "hiboux",
    "hockey", "homard", "homards", "hoquet", "hors", "huit",
    "huitième", "hurle", "hurler", "hurlement", "hutte", "hérisson",
    "hiérarchie", "hollande", "hongrie", "hongrois", "hasards",
})


def _sandhi(w: str, nxt: str) -> typing.Optional[typing.List[str]]:
    """Context-dependent function words (liaison/truncation).

    six/dix: [sis]/[dis] finally, [si]/[di] before a consonant-initial
    word, [siz]/[diz] in liaison (dix heures).  plus: [plys] finally,
    [ply] before a consonant, [plyz] in liaison.  neuf: [nœv] in the
    two lexicalized liaisons (neuf heures, neuf ans).
    """
    nxt = nxt.lower()
    entry = _LIAISON.get(w)
    if entry is not None:
        base, cons = entry
        if (
            nxt
            and nxt[0] in _VOWEL_INITIAL
            and nxt not in _LIAISON_BLOCKED_NEXT
        ):
            return list(base) + [cons]
        return None  # fall through to lexicon for the plain form
    if w in ("six", "dix"):
        head = ["s", "i"] if w == "six" else ["d", "i"]
        if not nxt:
            return head + ["s"]
        return head + (["z"] if nxt[0] in _VOWEL_INITIAL else [])
    if w == "plus":
        if not nxt:
            return ["p", "l", "y", "s"]
        if nxt[0] in _VOWEL_INITIAL:
            return ["p", "l", "y", "z"]
        return ["p", "l", "y"]
    if w == "neuf" and nxt in ("heures", "heure", "ans", "an"):
        return ["n", "œ", "v"]
    if w in ("deux", "trois") and nxt and nxt[0] in _VOWEL_INITIAL:
        # obligatory numeral liaison: deux euros [døz], trois ans [tʁwaz]
        head = ["d", "ø"] if w == "deux" else ["t", "ʁ", "w", "a"]
        return head + ["z"]
    if w == "huit" and nxt and nxt[0] not in _VOWEL_INITIAL:
        # the t drops before a consonant: huit minutes [ɥi minyt]
        return ["ɥ", "i"]
    if w == "vingt":
        # the t sounds in "vingt et un" and in liaison before a vowel
        # (vingt ans, vingt heures); silent otherwise (vingt minutes)
        if nxt == "et" or (nxt and nxt[0] in _VOWEL_INITIAL):
            return ["v", "ɛ̃", "t"]
        return ["v", "ɛ̃"]
    if w == "cent" and nxt and nxt[0] in _VOWEL_INITIAL and nxt not in (
        "et", "un", "une", "onze",
    ):
        # obligatory liaison: cent ans [sɑ̃tɑ̃]; but "cent un" [sɑ̃ œ̃]
        return ["s", "ɑ̃", "t"]
    return None


# French letter names (spell-out and ALL-CAPS initialisms)
_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "a": ["a"], "b": ["b", "e"], "c": ["s", "e"], "d": ["d", "e"],
    "e": ["ə"], "f": ["ɛ", "f"], "g": ["ʒ", "e"], "h": ["a", "ʃ"],
    "i": ["i"], "j": ["ʒ", "i"], "k": ["k", "a"], "l": ["ɛ", "l"],
    "m": ["ɛ", "m"], "n": ["ɛ", "n"], "o": ["o"], "p": ["p", "e"],
    "q": ["k", "y"], "r": ["ɛ", "ʁ"], "s": ["ɛ", "s"],
    "t": ["t", "e"], "u": ["y"], "v": ["v", "e"],
    "w": ["d", "u", "b", "l", "ə", "v", "e"], "x": ["i", "k", "s"],
    "y": ["i", "ɡ", "ʁ", "ɛ", "k"], "z": ["z", "ɛ", "d"],
}


def phonemize(
    word: str, prev: str = "", nxt: str = "",
    context: typing.Optional[typing.Sequence[str]] = None,
    index: int = -1,
) -> typing.List[str]:
    """French word -> IPA with NO stress marks.

    French has no lexical stress (prosodic stress is phrase-final), and
    the released fr-fr voice's golden fixtures confirm gruut emitted no
    stress ids at all (siwis test_phonemes.csv: zero occurrences of the
    inventory's ˈ id across every sentence) — emitting one here would
    feed the encoder an embedding it never saw in training.

    Hyphenated compounds stay one word group but are pronounced part by
    part (gruut: "avez-vous" -> a v e v u), with the number liaisons
    spelled out (vingt-cinq [vɛ̃t], quatre-vingt-onze [vɛ̃], dix-neuf
    [diz]).  Elided clitics (c'est, l'école) split at the apostrophe.
    """
    w = word.lower().strip()
    if not w:
        return []
    # ALL-CAPS initialisms spell their letters (SNCF, TGV, USA); real
    # words in caps (LA, IL — emphasis) keep their lexicon reading
    if (
        word.isupper()
        and word.isalpha()
        and 2 <= len(word) <= 6
        and w not in _EXCEPTIONS
        and w not in _ENT_VERB_FORMS
    ):
        return spell_letters(w, _LETTER_NAMES)
    # single spelled letters — but never the real one-letter words
    # (à, a, y [i], ô)
    if (
        len(w) == 1
        and w in _LETTER_NAMES
        and w not in _EXCEPTIONS
        and w not in ("a", "y")
    ):
        return spell_letters(w, _LETTER_NAMES)
    sandhi = _sandhi(w, nxt)
    if sandhi is not None:
        return sandhi
    hit = _EXCEPTIONS.get(w)
    if hit is not None:
        return list(hit)
    if "'" in w:
        prefix, _, rest = w.partition("'")
        head = _ELISION_PREFIXES.get(prefix)
        if head is not None and rest:
            return head + phonemize(rest, nxt=nxt)
    if "-" in w and len(w) > 1:
        parts = [p for p in w.split("-") if p]
        if len(parts) > 1:
            out: typing.List[str] = []
            for k, p in enumerate(parts):
                last = k + 1 == len(parts)
                if p == "vingt" and not last and (
                    k == 0 or parts[k - 1] != "quatre"
                ):
                    out += ["v", "ɛ̃", "t"]  # vingt-cinq ... vingt-neuf
                elif p == "dix" and not last:
                    # dix-neuf [diz], dix-huit [diz], dix-sept [di]
                    out += ["d", "i"] + (
                        ["z"] if parts[k + 1] in ("neuf", "huit") else []
                    )
                elif p == "t":
                    out += ["t"]  # inversion clitic: a-t-il
                else:
                    out += phonemize(p, nxt="" if last else parts[k + 1])
            return out
    if w in _ENT_VERB_FORMS:
        # silent verbal -ent: pronounce the stem with a mute final e
        return phonemize(w[:-3] + "e")
    # -aient is ALWAYS the imparfait/conditional 3pl (étaient,
    # pourraient) — no French noun ends in -aient; read it as -ait
    if w.endswith("aient") and len(w) > 5:
        return phonemize(w[:-5] + "ait")
    # è + 1-2 consonants + -ent is the 3pl of an è-alternating verb
    # (achètent, espèrent, mènent); -ent NOUNS never carry è there
    # (règlement/élément end in the -ment suffix, excluded)
    if (
        w.endswith("ent")
        and not w.endswith("ment")
        and re.search("è[bcdfghjklmnpqrstvz]{1,2}ent$", w)
    ):
        return phonemize(w[:-3] + "e")
    return apply_rules(w, _RULES, _context)


phonemize.context_aware = True  # type: ignore[attr-defined]
# words whose pronunciation depends on the next word must reach
# _sandhi even when the shared exception lexicon has an entry
phonemize.sandhi_words = frozenset(_LIAISON) | frozenset(
    ("six", "dix", "plus", "neuf", "vingt", "cent", "deux", "trois", "huit")
)  # type: ignore[attr-defined]
