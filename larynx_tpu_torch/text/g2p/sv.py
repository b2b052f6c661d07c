# Copied from larynx_tpu/text/g2p/sv.py; only the package name in its imports differs.
"""Swedish G2P — rule-based.

Inventory (local/sv-se/*/phonemes.txt): a b d eː f h iː j k l m n oː p r s
t uː v yː øː ŋ œ ɑː ɔ ɕ ɛ ɛː ɡ ɧ ɪ ɵ ʉː ʊ ʏ + stress marks ' and ².
Long/short vowel choice follows the following-consonant-count heuristic.
"""

import typing

from larynx_tpu_torch.text.g2p.rules import (
    apply_rules,
    spell_letters,
    stress_nth_vowel_from_end,
)

VOWELS = {
    "a", "ɑː", "eː", "ɛ", "ɛː", "iː", "ɪ", "oː", "ɔ", "uː", "ʊ", "ʉː",
    "ɵ", "yː", "ʏ", "øː", "œ",
}

_FRONT = "eiyäö"

# (long, short) pairs per orthographic vowel
_VOWEL_MAP = {
    "a": ("ɑː", "a"),
    "e": ("eː", "ɛ"),
    "i": ("iː", "ɪ"),
    "o": ("uː", "ʊ"),
    "u": ("ʉː", "ɵ"),
    "y": ("yː", "ʏ"),
    "å": ("oː", "ɔ"),
    "ä": ("ɛː", "ɛ"),
    "ö": ("øː", "œ"),
}

_RULES = [
    # whole-morpheme spellings that the letter rules mangle in compounds
    ("hundra", "h ɵ n d r a"),
    ("stj", "ɧ"), ("skj", "ɧ"), ("sj", "ɧ"),
    ("tj", "ɕ"), ("kj", "ɕ"),
    ("ng", "ŋ"),
    ("é", "eː"),
    ("ck", "k"),
    ("k", "k"),
    ("b", "b"), ("d", "d"), ("f", "f"), ("h", "h"), ("j", "j"),
    ("l", "l"), ("m", "m"), ("n", "n"), ("p", "p"), ("r", "r"),
    ("s", "s"), ("t", "t"), ("v", "v"), ("w", "v"), ("x", "k s"),
    ("z", "s"), ("c", "k"), ("q", "k"),
]


def _vowel_length(word: str, i: int) -> bool:
    """True if the vowel at position i is long (followed by <=1 consonant)."""
    # unstressed final-syllable a/e/o are short (tala, damen, tjugo —
    # matches the released-voice lexicon entries: "svävare" -> a r ɛ)
    if word[i] in "aeo" and i > 0 and not any(
        c in "aeiouyåäö" for c in word[i + 1 :]
    ) and any(c in "aeiouyåäö" for c in word[:i]):
        return False
    # the a of unstressed -are/-ade suffixes is short (läkare, slutade)
    if word[i] == "a" and i > 0 and word[i:] in (
        "are", "aren", "ares", "ade", "ades", "arna"
    ):
        return False
    j = i + 1
    count = 0
    while j < len(word) and word[j] not in "aeiouyåäö":
        count += 2 if word[j] == "x" else 1
        j += 1
    if count >= 2:
        return False
    return True


_DOUBLE_MAP = {
    "b": "b", "d": "d", "f": "f", "g": "ɡ", "k": "k", "l": "l",
    "m": "m", "n": "n", "p": "p", "r": "r", "s": "s", "t": "t",
}


def _context(word: str, i: int):
    ch = word[i]
    nxt = word[i + 1] if i + 1 < len(word) else ""
    prev = word[i - 1] if i > 0 else ""
    # word-initial silent-letter clusters: hjärta, djur, ljus, gjort
    if i == 0 and word[:2] in ("hj", "dj", "lj", "gj"):
        return 2, ["j"]
    # word-initial ch in French loans is the sj-sound (chef, choklad,
    # chans, chock); "och" is a lexicon entry
    if i == 0 and word.startswith("ch") and len(word) > 3:
        return 2, ["ɧ"]
    # Latin -tion(en/er) = [ɧuːn] (station, lektionen) — NOT the native
    # tio of tionde/nationde counting words.  The sv inventory has no ʃ;
    # the sj-sound ɧ is the voices' id for this suffix.
    if word.startswith("tion", i) and i > 0 and word[i + 4 :] in (
        "", "s", "en", "er", "ens", "erna"
    ):
        return 4, ["ɧ", "uː", "n"]
    # -sion/-gion read the same sj-sound (mission, pension, religion);
    # -ssion must beat the doubled-consonant rule (mission, diskussion)
    if (
        word.startswith("ssion", i)
        and i > 0
        and word[i + 5 :] in ("", "s", "en", "er", "ens", "erna")
    ):
        return 5, ["ɧ", "uː", "n"]
    if (
        (word.startswith("sion", i) or word.startswith("gion", i))
        and i > 0
        and word[i + 4 :] in ("", "s", "en", "er", "ens", "erna")
    ):
        return 4, ["ɧ", "uː", "n"]
    # abstract -het suffix keeps its full vowel (nyhet [²nˈyːheːt],
    # lägenheten): the unstressed-final-syllable shortening must not
    # reduce it to ɛ
    if word.startswith("het", i) and i > 0 and word[i + 3 :] in (
        "", "s", "en", "er", "ens", "erna"
    ) and any(c in "aeiouyåäö" for c in word[:i]):
        return 3, ["h", "eː", "t"]
    # n assimilates before k (tänka, bank)
    if ch == "n" and nxt == "k":
        return 1, ["ŋ"]
    # doubled consonants are single sounds (the vowel-length heuristic
    # already sees them as a cluster)
    if nxt == ch and ch in _DOUBLE_MAP:
        return 2, [_DOUBLE_MAP[ch]]
    # velar fronting applies at (stressed) word onset only: kök -> ɕøːk
    if i == 0 and ch == "k" and nxt and nxt in _FRONT:
        return 1, ["ɕ"]
    if (
        i == 0
        and word.startswith("sk", i)
        and (word[i + 2] if i + 2 < len(word) else "") in _FRONT
        and i + 2 < len(word)
    ):
        return 2, ["ɧ"]
    if i == 0 and ch == "g" and nxt and nxt in _FRONT:
        return 1, ["j"]
    # c softens before front vowels (cykel -> s)
    if ch == "c" and nxt and nxt in _FRONT:
        return 1, ["s"]
    # g devoices before voiceless s/t (sagt [sakt], högst [hœkst])
    if ch == "g" and nxt and nxt in "st":
        return 1, ["k"]
    # g after r/l at word end is [j] (berg, färg, torg)
    if ch == "g" and i + 1 == len(word) and prev in "rl":
        return 1, ["j"]
    if ch == "g":
        return 1, ["ɡ"]
    if ch in _VOWEL_MAP:
        long_sym, short_sym = _VOWEL_MAP[ch]
        return 1, [long_sym if _vowel_length(word, i) else short_sym]
    return None


# Short-vowel function words (the single-final-consonant heuristic says
# long) and irregulars; hand-verified standard Swedish.
_EXCEPTIONS: typing.Dict[str, typing.Tuple[str, ...]] = {
    # loanword/compound stress and accent-II marks the defaults miss
    # (pre-marked entries: stress_nth is a no-op when ' is present)
    "engelska": ("²", "'ɛ", "ŋ", "ɛ", "l", "s", "k", "a"),
    # fraction nouns: compound accent II with initial stress
    "tredjedel": ("²", "t", "r", "'eː", "d", "j", "ɛ", "d", "eː", "l"),
    "tredjedelar": ("²", "t", "r", "'eː", "d", "j", "ɛ", "d", "eː", "l", "a", "r"),
    "fjärdedel": ("²", "f", "j", "'ɛ", "r", "d", "ɛ", "d", "eː", "l"),
    "fjärdedelar": ("²", "f", "j", "'ɛ", "r", "d", "ɛ", "d", "eː", "l", "a", "r"),
    "femtedel": ("²", "f", "'ɛ", "m", "t", "ɛ", "d", "eː", "l"),
    "femtedelar": ("²", "f", "'ɛ", "m", "t", "ɛ", "d", "eː", "l", "a", "r"),
    "åttondel": ("²", "'ɔ", "t", "ɔ", "n", "d", "eː", "l"),
    "åttondelar": ("²", "'ɔ", "t", "ɔ", "n", "d", "eː", "l", "a", "r"),
    "tiondel": ("²", "t", "'iː", "ʊ", "n", "d", "eː", "l"),
    "tiondelar": ("²", "t", "'iː", "ʊ", "n", "d", "eː", "l", "a", "r"),
    "celsius": ("s", "'ɛ", "l", "s", "ɪ", "ɵ", "s"),
    "förstår": ("f", "œ", "r", "s", "t", "'oː", "r"),
    "förstå": ("f", "œ", "r", "s", "t", "'oː"),
    "förstod": ("f", "œ", "r", "s", "t", "'uː", "d"),
    "arbetar": ("²", "'a", "r", "b", "eː", "t", "a", "r"),
    "arbeta": ("²", "'a", "r", "b", "eː", "t", "a"),
    "arbete": ("²", "'a", "r", "b", "eː", "t", "ɛ"),
    "arbetet": ("²", "'a", "r", "b", "eː", "t", "ɛ", "t"),
    "trädgård": ("²", "t", "r", "'ɛ", "d", "ɡ", "oː", "r", "d"),
    "trädgården": ("²", "t", "r", "'ɛ", "d", "ɡ", "oː", "r", "d", "ɛ", "n"),
    "göteborg": ("j", "øː", "t", "ɛ", "b", "'ɔ", "r", "j"),
    "nyhet": ("²", "n", "'yː", "h", "eː", "t"),
    "nyheter": ("²", "n", "'yː", "h", "eː", "t", "ɛ", "r"),
    "fungerar": ("f", "ɵ", "ŋ", "ɡ", "'eː", "r", "a", "r"),
    "fungera": ("f", "ɵ", "ŋ", "ɡ", "'eː", "r", "a"),
    "minut": ("m", "iː", "n", "'ʉː", "t"),
    "minuten": ("m", "iː", "n", "'ʉː", "t", "ɛ", "n"),
    "minuter": ("m", "iː", "n", "'ʉː", "t", "ɛ", "r"),
    "flygplan": ("²", "f", "l", "'yː", "ɡ", "p", "l", "ɑː", "n"),
    "flygplanet": ("²", "f", "l", "'yː", "ɡ", "p", "l", "ɑː", "n", "ɛ", "t"),
    "fartyg": ("²", "f", "'ɑː", "r", "t", "yː", "ɡ"),
    "fartyget": ("²", "f", "'ɑː", "r", "t", "yː", "ɡ", "ɛ", "t"),
    "härifrån": ("h", "ɛː", "r", "iː", "f", "r", "'oː", "n"),
    "måndagar": ("²", "m", "'oː", "n", "d", "ɑː", "ɡ", "a", "r"),
    "tisdagar": ("²", "t", "'iː", "s", "d", "ɑː", "ɡ", "a", "r"),
    "onsdagar": ("²", "'ʊ", "n", "s", "d", "ɑː", "ɡ", "a", "r"),
    "torsdagar": ("²", "t", "'ʊ", "r", "s", "d", "ɑː", "ɡ", "a", "r"),
    "fredagar": ("²", "f", "r", "'eː", "d", "ɑː", "ɡ", "a", "r"),
    "lördagar": ("²", "l", "'œ", "r", "d", "ɑː", "ɡ", "a", "r"),
    "söndagar": ("²", "s", "'œ", "n", "d", "ɑː", "ɡ", "a", "r"),
    "intressant": ("ɪ", "n", "t", "r", "ɛ", "s", "'a", "n", "t"),
    "grönsaker": ("²", "ɡ", "r", "'œ", "n", "s", "ɑː", "k", "ɛ", "r"),
    "emot": ("eː", "m", "'uː", "t"),
    "huvudvärk": ("²", "h", "'ʉː", "v", "ɵ", "d", "v", "ɛ", "r", "k"),
    "tillverkar": ("²", "t", "'ɪ", "l", "v", "ɛ", "r", "k", "a", "r"),
    "månad": ("²", "m", "'oː", "n", "a", "d"),
    "månaden": ("²", "m", "'oː", "n", "a", "d", "ɛ", "n"),
    "månader": ("²", "m", "'oː", "n", "a", "d", "ɛ", "r"),
    "underbar": ("²", "'ɵ", "n", "d", "ɛ", "r", "b", "ɑː", "r"),
    "underbart": ("²", "'ɵ", "n", "d", "ɛ", "r", "b", "ɑː", "r", "t"),
    "morgonen": ("²", "m", "'ʊ", "r", "ɡ", "ʊ", "n", "ɛ", "n"),
    "fågel": ("²", "f", "'oː", "ɡ", "ɛ", "l"),
    "fåglar": ("²", "f", "'oː", "ɡ", "l", "a", "r"),
    "fåglarna": ("²", "f", "'oː", "ɡ", "l", "a", "r", "n", "a"),
    "läroböcker": ("²", "l", "'ɛː", "r", "uː", "b", "œ", "k", "ɛ", "r"),
    "återseende": ("²", "'oː", "t", "ɛ", "r", "s", "eː", "ɛ", "n", "d", "ɛ"),
    "långsammare": ("²", "l", "'ɔ", "ŋ", "s", "a", "m", "a", "r", "ɛ"),
    "procent": ("p", "r", "uː", "s", "'ɛ", "n", "t"),
    # 6-letter -ende participles miss the suffix guard (len > len+2)
    "gående": ("²", "ɡ", "'oː", "ɛ", "n", "d", "ɛ"),
    "stående": ("²", "s", "t", "'oː", "ɛ", "n", "d", "ɛ"),
    "leende": ("²", "l", "'eː", "ɛ", "n", "d", "ɛ"),
    "boende": ("²", "b", "'uː", "ɛ", "n", "d", "ɛ"),
    "närvarande": ("²", "n", "'ɛː", "r", "v", "ɑː", "r", "a", "n",
                   "d", "ɛ"),
    "besök": ("b", "ɛ", "s", "'øː", "k"),
    "besöker": ("b", "ɛ", "s", "'øː", "k", "ɛ", "r"),
    "besöka": ("b", "ɛ", "s", "'øː", "k", "a"),
    "idag": ("iː", "d", "'ɑː", "ɡ"),
    "igår": ("iː", "ɡ", "'oː", "r"),
    "imorgon": ("iː", "m", "'ʊ", "r", "ɡ", "ʊ", "n"),
    "maskin": ("m", "a", "ɧ", "'iː", "n"),
    "maskinen": ("m", "a", "ɧ", "'iː", "n", "ɛ", "n"),
    "maskiner": ("m", "a", "ɧ", "'iː", "n", "ɛ", "r"),
    "maskinerna": ("m", "a", "ɧ", "'iː", "n", "ɛ", "r", "n", "a"),
    "tjugo": ("²", "ɕ", "'ʉː", "ɡ", "ʊ"),
    "tionde": ("²", "t", "'iː", "ʊ", "n", "d", "ɛ"),
    "människa": ("²", "m", "'ɛ", "n", "ɪ", "ɧ", "a"),
    "människor": ("²", "m", "'ɛ", "n", "ɪ", "ɧ", "ʊ", "r"),
    "trettio": ("²", "t", "r", "'ɛ", "t", "iː", "ʊ"),
    "fyrtio": ("²", "f", "'ʏ", "r", "t", "iː", "ʊ"),
    "femtio": ("²", "f", "'ɛ", "m", "t", "iː", "ʊ"),
    "sextio": ("²", "s", "'ɛ", "k", "s", "t", "iː", "ʊ"),
    "sjuttio": ("²", "ɧ", "'ɵ", "t", "iː", "ʊ"),
    "åttio": ("²", "'ɔ", "t", "iː", "ʊ"),
    "nittio": ("²", "n", "'ɪ", "t", "iː", "ʊ"),
    "och": ("ɔ", "k"),
    "om": ("ɔ", "m"),
    "som": ("s", "ɔ", "m"),
    "men": ("m", "ɛ", "n"),
    "fem": ("f", "ɛ", "m"),
    "han": ("h", "a", "n"),
    "hon": ("h", "ʊ", "n"),
    "man": ("m", "a", "n"),
    "vän": ("v", "ɛ", "n"),
    "mun": ("m", "ɵ", "n"),
    "rum": ("r", "ɵ", "m"),
    "den": ("d", "ɛ", "n"),
    "min": ("m", "ɪ", "n"),
    "din": ("d", "ɪ", "n"),
    "sin": ("s", "ɪ", "n"),
    "det": ("d", "eː"),
    "vid": ("v", "iː", "d"),
    "att": ("a", "t"),
    "station": ("s", "t", "a", "ɧ", "'uː", "n"),
    "nation": ("n", "a", "ɧ", "'uː", "n"),
    "kanske": ("k", "a", "n", "ɧ", "ɛ"),
    "sverige": ("s", "v", "ɛ", "r", "j", "ɛ"),
    "mycket": ("m", "ʏ", "k", "ɛ", "t"),
    "morgon": ("m", "ɔ", "r", "ɡ", "ɔ", "n"),
    "varit": ("v", "ɑː", "r", "ɪ", "t"),
    "sedan": ("s", "eː", "d", "a", "n"),
    "huvud": ("h", "ʉː", "v", "ɵ", "d"),
    "kött": ("ɕ", "œ", "t"),
    "göra": ("j", "øː", "r", "a"),
    "hjärta": ("j", "ɛ", "r", "t", "a"),
    "barn": ("b", "ɑː", "r", "n"),
    "ord": ("uː", "r", "d"),
    "bord": ("b", "uː", "r", "d"),
    "jord": ("j", "uː", "r", "d"),
    "nord": ("n", "uː", "r", "d"),
    "lärare": ("²", "l", "'ɛː", "r", "a", "r", "ɛ"),
    "torg": ("t", "ɔ", "r", "j"),
    "augusti": ("a", "ɡ", "ɵ", "s", "t", "ɪ"),
    "miljon": ("m", "ɪ", "l", "j", "uː", "n"),
    "miljoner": ("m", "ɪ", "l", "j", "uː", "n", "ɛ", "r"),
    "telefon": ("t", "eː", "l", "eː", "f", "uː", "n"),
    "bibliotek": ("b", "ɪ", "b", "l", "ɪ", "uː", "t", "eː", "k"),
    "apotek": ("a", "p", "uː", "t", "eː", "k"),
    "universitet": ("ʉː", "n", "ɪ", "v", "ɛ", "r", "s", "ɪ", "t", "'eː", "t"),
    "universitetet": ("ʉː", "n", "ɪ", "v", "ɛ", "r", "s", "ɪ", "t", "'eː",
                      "t", "ɛ", "t"),
    "sjukhus": ("ɧ", "ʉː", "k", "h", "ʉː", "s"),
    # loanwords with final stress (pre-marked: the penult default and
    # the accent-2 prepend must not fire)
    "ekonomi": ("eː", "k", "uː", "n", "uː", "m", "'iː"),
    "ekonomin": ("eː", "k", "uː", "n", "uː", "m", "'iː", "n"),
    "naturligtvis": ("n", "a", "t", "ʉː", "r", "l", "ɪ", "ɡ", "t", "v",
                     "'iː", "s"),
    # medial soft g (regering [rɛˈjeːrɪŋ], egentligen [ɛˈjɛntlɪɡɛn])
    "regering": ("r", "ɛ", "j", "'eː", "r", "ɪ", "ŋ"),
    "regeringen": ("r", "ɛ", "j", "'eː", "r", "ɪ", "ŋ", "ɛ", "n"),
    "egentligen": ("eː", "j", "'ɛ", "n", "t", "l", "ɪ", "ɡ", "ɛ", "n"),
    "egentlig": ("eː", "j", "'ɛ", "n", "t", "l", "ɪ", "ɡ"),
    # compound/derived initial stress the penult default misses
    "vetenskap": ("²", "v", "'eː", "t", "ɛ", "n", "s", "k", "a", "p"),
    "vetenskapen": ("²", "v", "'eː", "t", "ɛ", "n", "s", "k", "a", "p",
                    "ɛ", "n"),
    "samhälle": ("²", "s", "'a", "m", "h", "ɛ", "l", "ɛ"),
    "samhället": ("²", "s", "'a", "m", "h", "ɛ", "l", "ɛ", "t"),
    "utveckling": ("²", "'ʉː", "t", "v", "ɛ", "k", "l", "ɪ", "ŋ"),
    "utvecklingen": ("²", "'ʉː", "t", "v", "ɛ", "k", "l", "ɪ", "ŋ",
                     "ɛ", "n"),
    "företag": ("²", "f", "'øː", "r", "ɛ", "t", "ɑː", "ɡ"),
    "företaget": ("²", "f", "'øː", "r", "ɛ", "t", "ɑː", "ɡ", "ɛ", "t"),
    "lägenhet": ("²", "l", "'ɛː", "ɡ", "ɛ", "n", "h", "eː", "t"),
    "lägenheten": ("²", "l", "'ɛː", "ɡ", "ɛ", "n", "h", "eː", "t",
                   "ɛ", "n"),
    "lägenheter": ("²", "l", "'ɛː", "ɡ", "ɛ", "n", "h", "eː", "t",
                   "ɛ", "r"),
    "historia": ("h", "ɪ", "s", "t", "'uː", "r", "iː", "a"),
    "historien": ("h", "ɪ", "s", "t", "'uː", "r", "iː", "ɛ", "n"),
    # silent l (värld [vɛːrd])
    "värld": ("v", "ɛː", "r", "d"),
    "världen": ("²", "v", "'ɛː", "r", "d", "ɛ", "n"),
    "världar": ("²", "v", "'ɛː", "r", "d", "a", "r"),
    # French loans: j/g/ch as the sj-sound where the rules cannot see
    "journalist": ("ɧ", "ʊ", "r", "n", "a", "l", "'ɪ", "s", "t"),
    "journalisten": ("ɧ", "ʊ", "r", "n", "a", "l", "'ɪ", "s", "t",
                     "ɛ", "n"),
    "journalister": ("ɧ", "ʊ", "r", "n", "a", "l", "'ɪ", "s", "t",
                     "ɛ", "r"),
    "jury": ("²", "ɧ", "'ʉː", "r", "ʏ"),
    "genre": ("²", "ɧ", "'a", "ŋ", "ɛ", "r"),
    "garage": ("ɡ", "a", "r", "'ɑː", "ɧ"),
    "garaget": ("ɡ", "a", "r", "'ɑː", "ɧ", "ɛ", "t"),
    "restaurang": ("r", "ɛ", "s", "t", "ʊ", "r", "'a", "ŋ"),
    "restaurangen": ("r", "ɛ", "s", "t", "ʊ", "r", "'a", "ŋ", "ɛ", "n"),
    "choklad": ("ɧ", "ʊ", "k", "l", "'ɑː", "d"),
    "chokladen": ("ɧ", "ʊ", "k", "l", "'ɑː", "d", "ɛ", "n"),
    # loanwords with stress/segments the rules cannot derive
    "miljon": ("m", "ɪ", "l", "j", "'uː", "n"),
    "miljoner": ("m", "ɪ", "l", "j", "'uː", "n", "ɛ", "r"),
    "aktie": ("²", "'a", "k", "t", "s", "ɪ", "ɛ"),
    "aktier": ("²", "'a", "k", "t", "s", "ɪ", "ɛ", "r"),
    "weekend": ("v", "'iː", "k", "ɛ", "n", "d"),
    "pizza": ("²", "p", "'ɪ", "t", "s", "a"),
    "pizzor": ("²", "p", "'ɪ", "t", "s", "ʊ", "r"),
    "zoo": ("s", "'uː"),
    "juice": ("j", "'uː", "s"),
    "exakt": ("ɛ", "k", "s", "'a", "k", "t"),
    "paraply": ("p", "a", "r", "a", "p", "l", "'yː"),
    "kemi": ("ɕ", "eː", "m", "'iː"),
    "kemin": ("ɕ", "eː", "m", "'iː", "n"),
    # place names / proper nouns the penult default mis-stresses
    "uppsala": ("²", "'ɵ", "p", "s", "ɑː", "l", "a"),
    "västerås": ("v", "ɛ", "s", "t", "ɛ", "r", "'oː", "s"),
    "örebro": ("²", "'øː", "r", "ɛ", "b", "r", "uː"),
    "linköping": ("²", "l", "'ɪ", "n", "ɕ", "øː", "p", "ɪ", "ŋ"),
    "frankrike": ("²", "f", "r", "'a", "ŋ", "k", "r", "iː", "k", "ɛ"),
    "andersson": ("²", "'a", "n", "d", "ɛ", "r", "s", "ʊ", "n"),
    "midsommar": ("²", "m", "'ɪ", "d", "s", "ʊ", "m", "a", "r"),
    "island": ("²", "'iː", "s", "l", "a", "n", "d"),
    # English tech loans
    "email": ("'iː", "m", "ɛ", "j", "l"),
    "e-mail": ("'iː", "m", "ɛ", "j", "l"),
    "online": ("ʊ", "n", "l", "'a", "j", "n"),
    "smartphone": ("s", "m", "'a", "r", "t", "f", "oː", "n"),
    "google": ("ɡ", "'uː", "ɡ", "ɛ", "l"),
    "youtube": ("j", "'ʉː", "t", "ʉː", "b"),
    "wifi": ("v", "'a", "j", "f", "a", "j"),
    # short-vowel monosyllables the single-final-consonant heuristic
    # would lengthen
    "kom": ("k", "'ʊ", "m"),
    "män": ("m", "'ɛ", "n"),
    # bättre would otherwise match the ...tre number-compound tail
    "bättre": ("²", "b", "'ɛ", "t", "r", "ɛ"),
    "domstol": ("²", "d", "'ʊ", "m", "s", "t", "uː", "l"),
    # compound/derived initial stress (er+faren, upp+märksam)
    "erfarenhet": ("²", "'eː", "r", "f", "ɑː", "r", "ɛ", "n", "h",
                   "eː", "t"),
    "erfarenheten": ("²", "'eː", "r", "f", "ɑː", "r", "ɛ", "n", "h",
                     "eː", "t", "ɛ", "n"),
    "uppmärksamhet": ("²", "'ɵ", "p", "m", "ɛ", "r", "k", "s", "a",
                      "m", "h", "eː", "t"),
}


# Unstressed inflection/derivation suffixes: the stress stays on the
# stem (gästerna [ˈjɛsterna], slutade [ˈslʉːtadə], läkare [ˈlɛːkarə],
# våningen [ˈvoːnɪŋen], nyttiga [ˈnʏtːɪɡa]).  Value = vowel count.
_NEUTRAL_SUFFIXES = (
    ("ande", 2), ("ende", 2),  # participles stress the stem (följande)
    ("ingen", 2), ("erna", 2), ("arna", 2), ("orna", 2), ("ades", 2),
    ("elser", 2), ("else", 2),
    ("ligheter", 3), ("igheter", 3), ("erheter", 3),
    ("lighet", 2), ("ighet", 2), ("erhet", 2),
    ("aren", 2), ("ade", 2), ("are", 2), ("ena", 2), ("iga", 2),
)

# be-ROOT words the prefix rule must not split (ben/beta/bebis
# inflections pass the onset test but are roots with initial stress)
_BE_ROOT = frozenset({
    "benen", "benet", "bebis", "bebisar", "bedja", "betar", "betade",
    "betat", "beten", "betet", "besten", "bestar",
})
_BE_STEM_CLUSTERS = frozenset({
    "bl", "br", "dr", "fj", "fl", "fr", "gl", "gr", "gn", "kl", "kn",
    "kr", "kv", "pl", "pr", "sk", "sl", "sm", "sn", "sp", "st", "sv",
    "tr", "tv", "vr", "tj",
})

# Compound numbers stress the final element (fyrtiofem [fʏrtiʊˈfɛm])
_NUM_TAILS = ("åtta", "fyra", "ett", "två", "tre", "fem", "sex", "sju",
              "nio")

# Initial-stress polysyllables that the talesyntese fixture pins WITHOUT
# the grave accent (allting -> ' a l t ɪ ŋ)
_ACCENT1 = frozenset({"allting"})


def _with_accent2(w: str, phonemes: typing.List[str]) -> typing.List[str]:
    """Prepend the grave-accent id ² for accent-II words.

    The talesyntese fixture shows gruut emitted a standalone ² before
    initial-stressed polysyllables (² v 'ɑː r a, ² d 'ɑː m ɛ n,
    ² 'a l d r ɪ ɡ) but not before words with non-initial stress
    (b ɛ t 'ɑː l a r) — approximated here as: two-plus vowels with the
    stress on the first one.
    """
    if w in _ACCENT1:
        return phonemes
    vowel_idx = [k for k, p in enumerate(phonemes)
                 if p.lstrip("'") in VOWELS]
    if len(vowel_idx) >= 2 and phonemes[vowel_idx[0]].startswith("'"):
        return ["²"] + phonemes
    return phonemes



# Swedish letter names (spell-out / ALL-CAPS initialisms), unstressed
_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "a": ["ɑː"], "b": ["b", "eː"], "c": ["s", "eː"], "d": ["d", "eː"],
    "e": ["eː"], "f": ["ɛ", "f"], "g": ["ɡ", "eː"], "h": ["h", "oː"],
    "i": ["iː"], "j": ["j", "iː"], "k": ["k", "oː"], "l": ["ɛ", "l"],
    "m": ["ɛ", "m"], "n": ["ɛ", "n"], "o": ["uː"], "p": ["p", "eː"],
    "q": ["k", "ʉː"], "r": ["ɛ", "r"], "s": ["ɛ", "s"],
    "t": ["t", "eː"], "u": ["ʉː"], "v": ["v", "eː"],
    "w": ["d", "ɵ", "b", "ə", "l", "v", "eː"], "x": ["ɛ", "k", "s"],
    "y": ["yː"], "z": ["s", "ɛ", "t", "a"],
    "å": ["oː"], "ä": ["ɛː"], "ö": ["øː"],
}


def phonemize(word: str) -> typing.List[str]:
    w = word.lower().strip()
    if not w:
        return []
    # single letters spell their names — except the one-letter words
    # i (preposition), å (river), ö (island)
    if word.isalpha() and (
        (word.isupper() and 2 <= len(word) <= 6)
        or (len(word) == 1 and w not in ("i", "å", "ö"))
    ) and w not in _EXCEPTIONS and all(c in _LETTER_NAMES for c in w):
        return spell_letters(w, _LETTER_NAMES)
    # a written acute é marks the stressed (final) syllable in loanwords
    # (café, privé / idé, armé, kommitté) — override the penult default;
    # bare -tion loans likewise stress the suffix (lektion [lɛkˈɧuːn])
    n = 1 if ("é" in w or (w.endswith(("tion", "tions")) and len(w) > 4)) \
        else 2
    # more final-stress loan suffixes: -sion/-gion (mission, religion),
    # -ös (religiös, nervös), -in (bensin, kanin — native -vin compounds
    # like rödvin keep head stress), Greek -ologi/-ografi/-ergi/-emi/-ofi
    if n == 2 and len(w) > 4 and w.endswith(
        ("sion", "sions", "gion", "gions", "ös", "öst", "ösa",
         "in", "ologi", "ografi", "ergi", "emi", "ofi")
    ) and not w.endswith("vin"):
        n = 1
    hit = _EXCEPTIONS.get(w)
    if hit is not None:
        stressed = stress_nth_vowel_from_end(
            list(hit), VOWELS, n=n, marker="'"
        )
        if "²" in hit:
            return stressed
        return _with_accent2(w, stressed)
    # unstressed be- prefix: [b ɛ] + the stem's own stress and no ²
    # (betalar, befolkning, beundra).  Swedish vowel length marks
    # stress in these voices — the inventory has no plain short e, and
    # an unstressed LONG [beː-] is phonologically unrepresentable; the
    # non-initial stress also suppresses the grave accent (matching the
    # convention note in _with_accent2).  be-ROOT words are blocklisted
    # (benen) or fail the stem-onset test (bensin, berget).
    if (
        w.startswith("be")
        and len(w) > 4
        and w not in _BE_ROOT
        and any(c in "aeiouyåäö" for c in w[2:])
    ):
        stem = w[2:]
        onset_ok = (
            stem[0] in "aeiouyåäö"
            or (len(stem) > 1 and stem[1] in "aeiouyåäö")
            or stem[:2] in _BE_STEM_CLUSTERS
        )
        if onset_ok:
            return ["b", "ɛ"] + [p for p in phonemize(stem) if p != "²"]
    # compound numbers: unstressed head + the final element's own
    # pronunciation (trehundrasextiofem -> ...sextio + 'fem)
    for tail in _NUM_TAILS:
        if w.endswith(tail) and len(w) > len(tail) + 2:
            head = apply_rules(w[: -len(tail)], _RULES, _context)
            tail_ph = [p for p in phonemize(tail) if p != "²"]
            return head + tail_ph
    # adjectival -(l)ig suffixes: short ɪ (talesyntese: trevlig ->
    # t r 'eː v l ɪ ɡ, aldrig -> 'a l d r ɪ ɡ), stem keeps its OWN
    # vowel length (the suffix onset must not count as a cluster) and
    # its own stress (vänlig reuses the short-ɛ lexicon entry for vän)
    for sfx in ("ligast", "ligare", "ligen", "liga", "ligt", "lig",
                "igast", "igare", "igen", "iga", "igt", "ig"):
        if w.endswith(sfx) and len(w) > len(sfx) + 1:
            stem = w[: len(w) - len(sfx)]
            if not any(c in "aeiouyåäö" for c in stem):
                break
            hit = _EXCEPTIONS.get(stem)
            if hit is not None and not any(
                p == "²" or p.startswith("'") for p in hit
            ):
                head = list(hit)
            else:
                head = apply_rules(stem, _RULES, _context)
            rest = sfx.split("ig", 1)[1]
            tail = (["l"] if sfx.startswith("l") else []) + ["ɪ", "ɡ"] + {
                "": [], "t": ["t"], "a": ["a"], "en": ["ɛ", "n"],
                "are": ["a", "r", "ɛ"], "ast": ["a", "s", "t"],
            }[rest]
            stressed = stress_nth_vowel_from_end(
                head + tail, VOWELS,
                n=1 + sum(p in VOWELS for p in tail), marker="'"
            )
            return _with_accent2(w, stressed)
    if n == 2:
        for suf, k in _NEUTRAL_SUFFIXES:
            if w.endswith(suf) and len(w) > len(suf) + 2:
                n = k + 1
                break
    phonemes = apply_rules(w, _RULES, _context)
    # Swedish voices use ' as the stress mark
    stressed = stress_nth_vowel_from_end(phonemes, VOWELS, n=n, marker="'")
    return _with_accent2(w, stressed)
