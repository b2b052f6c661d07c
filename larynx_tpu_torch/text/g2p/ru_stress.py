# Copied from larynx_tpu/text/g2p/ru_stress.py; only the package name in its imports and the reference path in a comment differ.
"""Russian lexical stress placement.

The reference delegated Russian pronunciation to gruut's ru lexicon
(larynx/__init__.py:71-73 feeds ``gruut.sentences``);
the one thing that lexicon buys which letter rules cannot is STRESS
POSITION, which the ru-ru voices encode as vowel length (see ru.py).
This module is the in-tree replacement: a layered stress system over
hand-authored data.

Layers (first match wins), keyed on the lowercased Cyrillic word:

1. ``ё`` is inherently stressed (guaranteed by Russian orthography).
2. Exact-form lexicon — irregular and mobile-stress forms enumerated
   ("го́лову" vs "голова́", "была́" vs "бы́ли").
3. Stem lexicon + inflectional-ending stripping.  Two stem classes:
   fixed (``д+ел`` stresses the marked stem vowel in every form:
   де́лать, де́лали) and ending-stressed (``язык+`` stresses the first
   ending vowel: языка́, языки́, говори́т; bare forms with no ending
   vowel fall back to the last stem vowel: язы́к).  A trailing
   reflexive ся/сь is stripped before matching (its vowel never
   carries stress in the regular paradigms; начался́-type exceptions
   live in the exact lexicon).
4. Derivational suffix rules (-е́ние, -а́ция, -и́зм, -и́ст, -и́ровать,
   -и́ческий, -а́льный, -тель, infinitive theme vowels, …).
5. Defaults: monosyllables are stressed unless clitics (бы, не, ли,
   же, …, matching the golden fixtures' unstressed "бы"/"не"/"ли" but
   stressed "вы"/"на"); words with adjectival 2-vowel endings
   (-ая/-ого/-ыми, …) default to the antepenult (но́вая, но́вого);
   everything else defaults to the penult.

Data notation: ``+`` immediately precedes the stressed vowel letter
(``молок+о``); a trailing ``+`` marks an ending-stressed stem
(``язык+``); a token containing ``ё`` needs no marker.  Notation is
validated at import — a malformed token raises, it cannot silently
misplace stress.
"""

import re
import typing

VOWEL_LETTERS = "аеёиоуыэюя"
_VOWEL_RE = re.compile("[" + VOWEL_LETTERS + "]")

# Particles gruut leaves unstressed (golden fixtures: "бы" -> b ɨ,
# "не" -> nʲ e, "ли" -> lʲ i).  Prepositions ("на", "с") and pronouns
# ("вы") DO carry stress in the fixtures, so they are not listed.
CLITICS = {"бы", "б", "ли", "ль", "же", "ж", "не", "ни"}

# ---------------------------------------------------------------------------
# Layer 2: exact word forms ('+' before the stressed vowel).
# Mobile-stress paradigm members, irregular verbs, common adverbs and
# function words whose stress the stem layer or defaults would miss.
# ---------------------------------------------------------------------------
_EXACT_RAW = """
он+а он+о он+и мен+я теб+я ег+о теб+е ем+у тоб+ой соб+ой себ+я себ+е
ког+о чег+о ком+у чем+у
сам+а сам+о с+ами сам+ого сам+ому сам+их сам+им
мо+я мо+и мо+его мо+ей мо+ему мо+им мо+их
тво+я тво+и тво+его тво+ей тво+ему
сво+я сво+и сво+его сво+ей сво+ему сво+им сво+их
н+аша н+аше н+аши н+ашего н+ашей н+ашему н+аших
в+аша в+аше в+аши в+ашего в+ашей в+ашему
+этот +эта +это +эти +этого +этому +этим +этих +этой
тог+о том+у
вс+его вс+ему одн+ако
был+а б+ыло б+ыли б+ыть б+удет б+удут б+уду б+удешь б+удем б+удете
дал+а д+али д+ало даёт да+ют дад+ут дад+им д+айте дав+ай дав+айте
жил+а ж+или ж+ило живёт жив+ут жив+у живёшь жив+ём
брал+а бр+али бр+ало берёт бер+ут бер+у берёшь
взял+а вз+яли вз+яло возьмёт возьм+ут возьм+у
н+ачал начал+а н+ачали нач+ать начн+ёт начн+ут началс+я
п+онял понял+а п+оняли пон+ять поймёт пойм+ут пойм+у
пр+инял принял+а пр+иняли прин+ять пр+имет пр+имут
+умер умерл+а +умерли умер+еть умрёт умр+ут
шл+а идт+и ид+ут ид+у идёшь ид+я
пошл+а пошл+и пойт+и пойд+ут пойд+у
пришл+а пришл+и прийт+и прид+ут прид+у
нашл+а нашл+и найт+и найд+ут найд+у
ушл+а ушл+и уйт+и уйд+ут уйд+у
в+ышел в+ышла в+ышли в+ыйти в+ыйдет в+ыйдут
+ели +ела ед+ят ед+им ед+ите
хорош+о пл+охо легк+о далек+о высок+о глубок+о широк+о
давн+о темн+о светл+о тепл+о х+олодно тр+удно смешн+о
сейч+ас тогд+а всегд+а иногд+а никогд+а когд+а з+автра
вчер+а сег+одня п+оздно р+ано +утром в+ечером н+очью днём
ещё уж+е +очень почт+и совс+ем вообщ+е оп+ять сн+ова
пот+ом зат+ем потом+у поэтом+у снач+ала внач+але
хот+я +если чт+обы гд+е-то куд+а-то когд+а-то как+ой-то чт+о-то
б+ольше м+еньше л+учше х+уже р+аньше п+озже бл+иже д+альше
голов+а г+олову г+оловы голов+ы гол+ов голов+ам
рук+а р+уку р+уки рук+и рук+ам рук+ами рук+ах
ног+а н+огу н+оги ног+и ног+ам ног+ами ног+ах
вод+а в+оду в+оды вод+ы вод+ам
земл+я з+емлю з+емли земл+и зем+ель
зим+а з+иму з+имы
стен+а ст+ену ст+ены стен+ы
цен+а ц+ену ц+ены цен+ы
душ+а д+ушу д+уши душ+и
гор+а г+ору г+оры гор+ы гор+ам
стран+а стр+аны стр+анами
сторон+а ст+орону ст+ороны сторон+ы стор+он сторон+ам
окн+о +окна +окна +окон +окнами
игр+а игр+у +игры игр+ам
сел+о сёла сел+а
мор+е мор+я мор+ей мор+ям
п+оле пол+я пол+ей пол+ям
сл+ово слов+а слов+ам сл+ове
д+ело дел+а дел+ам д+еле
м+есто мест+а мест+ам м+есте
лиц+о л+ица лиц+ам
+имя имен+а имён +имени имен+ам
вр+емя времен+а времён вр+емени времен+ам
д+ерево дер+евья дер+евьев
+озеро озёра озёр
г+ород г+орода город+ов город+ам г+ороде
д+ома дом+ов дом+ам д+оме
лес+а лес+ов лес+ам л+есе лес+ах
глаз+а глаз+ам гл+азе глаз+ах
голос+а голос+ов г+олосе
берег+а берег+ов б+ереге
в+ечера вечер+ов в+ечере
номер+а номер+ов н+омере
поезд+а поезд+ов п+оезде
адрес+а адрес+ов +адресе
доктор+а доктор+ов д+окторе
профессор+а учител+я директор+а мастер+а
бр+атья бр+атьев бр+атьям
друзь+я друз+ей друзь+ям
сыновь+я сынов+ей
мужь+я муж+ей
ст+улья ст+ульев
л+истья л+истьев
дер+евья дер+евьев
п+ерья пер+о п+ерьев
огн+я огн+ю огн+и ог+онь
конц+а конц+у конц+ы конц+ов кон+ец
отц+а отц+у отц+ы отц+ов от+ец
д+еньги д+енег деньг+ам деньг+ами деньг+ах
л+юди люд+ей л+юдям людьм+и л+юдях
д+ети дет+ей д+етям детьм+и д+етях
м+атери матер+ей матер+ям м+атерью
д+очери дочер+ей дочер+ям
н+очи ноч+ей ноч+ам
дв+ери двер+ей двер+ям дв+ерью
л+ошади лошад+ей лошадьм+и
пл+ощади площад+ей площад+ям пл+ощадь
н+овости новост+ей новост+ям н+овость
по+этому д+еятельность д+еятельности д+еятельностью д+еятель
д+еятели д+еятеля д+еятелей
+области област+ей +область
ч+асти част+ей част+ям
+очереди очеред+ей +очередь
ц+еркви церкв+ей ц+ерковь
любв+и люб+овь люб+овью
кр+ови кр+овью
чет+ыре дев+ять д+есять
дв+адцать тр+идцать с+орок пятьдес+ят шестьдес+ят с+емьдесят
в+осемьдесят девян+осто дв+ести тр+иста чет+ыреста пятьс+от
т+ысяча т+ысячи милли+он милли+она милли+оны
п+ервый втор+ой тр+етий четвёртый п+ятый шест+ой седьм+ой
восьм+ой дев+ятый дес+ятый сот+ый т+ысячный
од+ин одн+а одн+о одн+и одног+о одном+у одн+им одн+их одн+ой
+оба +обе об+оих
од+иннадцать двен+адцать трин+адцать четырн+адцать пятн+адцать
шестн+адцать семн+адцать восемн+адцать девятн+адцать
б+абушка д+едушка д+евушка теп+ерь
ничег+о никог+о ником+у нич+ем
ед+а ед+ы жд+али ждал+а любл+ю купл+ю
к+упит к+упят л+юбит л+юбят см+отрит см+отрят пр+осит пр+осят
н+осит н+осят х+одит х+одят в+одит +учит +учат пл+атит
+яблоко +яблоки +облако облак+а з+еркало з+еркала
письм+о п+исьма п+исем числ+о ч+исла
+ягода +ягоды н+есколько мн+огие мн+огих немн+ого
+общество +обществе к+ачество кол+ичество
час+ы час+ов час+ам семь+я семь+е семь+и
ч+етверть ч+етверти ц+ельсия фаренг+ейта
молок+о молок+а хл+еба
зов+ут зов+у год+у утр+а утр+у кин+о запят+ая хоч+у по+ют
прибыл+а пр+ибыл пр+ибыли ж+енщина ж+енщины ж+енщину ж+енщинам
сад+у сад+ы
сл+ышат д+ержат д+ышат
полет+ел полет+ела полет+ели принесл+а принесл+и перенесл+а
постр+оил постр+оила постр+оили устр+оил устр+оила
в+ыборы в+ыборов в+ыбор в+ыбора в+ыбрал в+ыбрали в+ыход в+ыхода
журн+ал журн+ала журн+алы кан+ал кан+ала генер+ал генер+ала
петерб+ург петерб+урге петерб+урга сиб+ирь сиб+ири кавк+аз кавк+азе
мин+истр мин+истра мин+истры мин+истров
шестьс+от семьс+от восемьс+от девятьс+от
рек+а р+еку рек+е рек+и рек+ой
л+етом зим+ой весн+ой +осень +осени +осенью
+учится +учатся
откр+ыт откр+ыта откр+ыто откр+ыты закр+ыт
накр+ыт накр+ыта накр+ыто накр+ыты
з+аперт з+аперта з+аперто з+аперты
видн+ы видн+а видн+о
провер+яет провер+яю провер+яют провер+ять провер+ял провер+яла
провер+яли
обор+удование обор+удования обор+удованию обор+удованием
каф+е метр+о пальт+о такс+и р+адио жюр+и параш+ют параш+юта
объ+ект объ+екта объ+екту объ+екте объ+екты объ+ектов
субъ+ект субъ+екта субъ+екту субъ+екте субъ+екты субъ+ектов
онл+айн им+ейл вайф+ай смартф+он смартф+она ют+уб подк+аст
подк+аста бр+аузер бр+аузера
новосиб+ирск новосиб+ирске екатеринб+ург екатеринб+урге
каз+ань каз+ани серг+ей серг+ея андр+ей андр+ея алекс+ей алекс+ея
алекс+андр алекс+андра нев+а нев+е ур+ал ур+але байк+ал байк+але
толст+ой толст+ого иван+ов иван+ова петр+ов петр+ова с+идоров
смирн+ов смирн+ова кузнец+ов кузнец+ова
рождеств+о рождеств+а сред+а ср+еду
"""

# ---------------------------------------------------------------------------
# Layer 3: stems.  '+' before a vowel = fixed stress on that stem vowel
# in every inflected form; trailing '+' = ending-stressed.
# ---------------------------------------------------------------------------
_STEM_RAW = """
язык+ стол+ двор+ нож+ ключ+ врач+ труд+ плод+ мост+ дожд+ гвозд+
рубл+ словар+ календар+ секретар+ фонар+ корабл+ кремл+ пут+
январ+ феврал+ сентябр+ октябр+ ноябр+ декабр+ цар+
карандаш+ этаж+ гараж+ малыш+ топор+ ковр+ зонт+ куст+ лист+
хвост+ мяч+ слон+ кот+ бык+ орл+ звонк+ куск+ значк+
сапог+ пирог+ утюг+
говор+ сто+ леж+ сид+ молч+ звон+ шум+ спеш+ беж+ крич+ стуч+
нес+ вез+ вед+ вел+ рос+ тряс+ помог+ мог+ хот+
чит+ игр+ лет+ пис+ сказ+ показ+ рассказ+ заказ+ побед+
поним+ отвеч+ объясн+ получ+ реш+ счит+ молок+ люб+ смотр+ прос+
больш+ друг+ втор+ молод+ жив+ прост+ сух+ худ+
д+ел сд+ел д+ум под+ум сл+уш посл+уш спр+аш встр+ет
прим+ер университ+ет господ+ин велосип+ед д+оллар +евр ф+унт ц+ент
раб+от зн+а узн+а ч+увств в+ид ув+ид сл+ыш усл+ыш
сл+едующ раб+отающ д+елающ зн+ающ б+удущ д+ействующ
сег+одняшн
соотв+етствующ уч+ащ нач+инающ жел+ающ игр+ающ чит+ающ
ст+ав пост+ав п+омн зап+омн в+ер пров+ер зн+ач гот+ов
пр+ав ч+ист +ех +ед при+ех у+ех
кн+иг маш+ин к+омнат дор+ог м+узык д+евочк б+абочк
з+еркал +ягод удов+ольств
сов+ет сов+етск отв+ет прив+ет мом+ент вопр+ос зак+он ур+ок
магаз+ин телеф+он микроф+он интерн+ет челов+ек студ+ент гер+о
н+ов ст+ар д+обр кр+асн б+ел т+ёпл х+олодн тр+удн гл+авн
в+ажн р+азн крас+ив своб+одн об+ычн посл+едн
хор+ош м+аленьк р+усск
гриб+ жук+ кит+ луч+ петух+ плащ+ пруд+ столб+ холм+ шалаш+
еж+ уж+ борщ+ плот+ кнут+ прут+ хлыст+ дрозд+ лещ+ крот+ клоп+
жен+ сестр+ звезд+ гнезд+ ведр+ лун+ трав+
волн+ гроз+ дыр+ игл+ коз+ нор+ скал+ сосн+ стрел+ строк+
струн+ щек+ тюрьм+ судьб+
голуб+ плох+ глух+ слеп+ крив+
плет+ плел+ спас+ цвел+ цвет+ весн+ раст+ зав+од
ив+ан вокз+ал гр+адус москв+ виз+ит +улиц с+ахар ок+онч напис+
вт+орник муз+е те+атр конц+ерт понед+ельник п+ятниц четверг+
больн+ бол+ мин+ут уч+ебник инжен+ер дикт+ант мор+оз с+евер
с+еверн м+едленн
"""

_ENDINGS = (
    # longest first within the match loop (sorted at parse time)
    "",
    "а", "я", "о", "е", "и", "ы", "у", "ю", "ь",
    "ой", "ою", "ей", "ею", "ом", "ем", "ам", "ям", "ах", "ях",
    "ов", "ев", "ий", "ый", "ая", "яя", "ое", "ее", "ие", "ые",
    "ую", "юю", "ым", "им", "ых", "их",
    "ами", "ями", "ыми", "ими",
    "ого", "его", "ому", "ему",
    "ть", "ти", "чь", "л", "ла", "ло", "ли", "й", "йте",
    "ешь", "ет", "ете", "ут", "ют", "ишь", "ит", "ите", "ат", "ят",
    "ал", "ала", "ало", "али", "ял", "яла", "яло", "яли",
    "ил", "ила", "ило", "или", "ел", "ела", "ело", "ели",
    "ыл", "ыла", "ыло", "ыли",
    "ать", "ять", "ить", "еть", "уть", "ыть", "оть",
    "аю", "аешь", "ает", "аем", "аете", "ают", "ай", "айте",
    "яю", "яешь", "яет", "яем", "яете", "яют",
    "ую", "уешь", "ует", "уем", "уете", "уют",
    "ею", "еешь", "еет", "еем", "еете", "еют",
    "ив", "ивать", "ивал", "ивала", "ивали", "ивало",
    "иваю", "иваешь", "ивает", "иваем", "иваете", "ивают",
    "ен", "ена", "ено", "ены",
)

# ---------------------------------------------------------------------------
# Layer 4: derivational suffix rules.  Each pattern's group(1) is the
# stressed vowel letter; rules are tried in order.
# ---------------------------------------------------------------------------
_SUFFIX_RULES = [
    # 1st-conj reflexive present: the theme а/я is stressed (начина́ется,
    # закрыва́ется, занима́юсь).  Non-reflexive forms land on the same
    # vowel via the plain penult default; the ся/сь syllable shifts the
    # penult off it, hence the explicit rule.
    re.compile(r"([ая])(?:ю|ешь|ет|ем|ете|ют)(?:ся|сь)$"),
    # движ-е́ни-е, зада́ние, влия́ние (matches the suffix vowel itself)
    re.compile(r"([еая])ни(?:е|я|ю|ем|и|й|ям|ями|ях)$"),
    # информа́ция / информа́ции / ...
    re.compile(r"([а])ци(?:я|и|ю|ей|ям|ями|ях|й)$"),
    # капитал-и́зм, тур-и́ст(ка)
    re.compile(r"([и])зм(?:а|у|е|ом|ы|ов)?$"),
    # Latin agent/office loans: студе́нт, президе́нт, аспира́нт
    re.compile(r"([еа])нт(?:а|у|е|ом|ы|ов|ам|ах|ами)?$"),
    # result/person loans in -а́т: результа́т, депута́т, адвока́т
    # (native words ending -ат are rare; за́пад ends -ад, бра́т is
    # monosyllabic and unaffected)
    re.compile(r"([а])т(?:а|у|е|ом|ы|ов|ам|ах|ами)?$"),
    re.compile(r"([и])ст(?:а|у|е|ом|ы|ов|ам|ах|ами|ка|ки|ке|ку|ок)?$"),
    # план-и́ровать and its conjugation
    re.compile(r"([и])ру(?:ю|ешь|ет|ем|ете|ют)$"),
    re.compile(r"([и])рова(?:ть|л|ла|ли|ло|в|нн\w*)$"),
    # полит-и́ческ-ий
    re.compile(r"([и])ческ"),
    # норма́льный, акти́вный, революцио́нный
    re.compile(r"([а])льн(?:ый|ого|ому|ым|ом|ая|ой|ую|ое|ые|ых|ыми|о)$"),
    re.compile(r"([и])вн(?:ый|ого|ому|ым|ом|ая|ой|ую|ое|ые|ых|ыми|о)$"),
    re.compile(r"([ио])нн(?:ый|ого|ому|ым|ом|ая|ой|ую|ое|ые|ых|ыми|о)$"),
    # учи́-тель, писа́-тел-я, прави́-тельств-о: stress the vowel right
    # before -тель/-тельств
    re.compile(r"([аеиоуыэюя])тел(?:ь|я|ю|ем|и|ей|ям|ями|ях|ьн\w*|ьств\w*)$"),
    # infinitive theme vowels (говор-и́ть, чит-а́ть, смотр-е́ть); the
    # stem-stressed high-frequency exceptions (де́лать, ви́деть, …)
    # are caught by layer 3 first
    re.compile(r"([иае])ть(?:ся)?$"),
    # и-verb past forms are end-stressed far more often than not
    # (купи́л, плати́ла); the retraction class (ста́вил, ве́рил, …)
    # is in layer 3
    re.compile(r"([и])л(?:а|о|и)?(?:сь|ся)?$"),
]


def _accent_to_index(token: str) -> typing.Tuple[str, int]:
    """``молок+о`` -> ("молоко", 2): word + stressed-vowel ordinal."""
    plus = token.index("+")
    word = token.replace("+", "")
    if "ё" in word and plus == len(token) - 1:
        raise ValueError(f"ru_stress: ё token with trailing '+': {token!r}")
    marked = token[plus + 1]
    if marked not in VOWEL_LETTERS:
        raise ValueError(f"ru_stress: '+' must precede a vowel: {token!r}")
    return word, len(_VOWEL_RE.findall(token[:plus]))


def _parse_exact(raw: str) -> typing.Dict[str, int]:
    out: typing.Dict[str, int] = {}
    for token in raw.split():
        if not re.fullmatch(r"[а-яё+-]+", token):
            raise ValueError(f"ru_stress: malformed exact token {token!r}")
        if "ё" in token and "+" not in token:
            continue  # ё carries the stress; layer 1 handles it
        if token.count("+") != 1:
            raise ValueError(f"ru_stress: need exactly one '+': {token!r}")
        word, idx = _accent_to_index(token)
        out[word] = idx
    return out


# stem value: >=0 -> fixed stress on that stem-vowel ordinal; -1 -> E class
_END_STRESSED = -1


def _parse_stems(raw: str) -> typing.Dict[str, int]:
    out: typing.Dict[str, int] = {}
    for token in raw.split():
        if not re.fullmatch(r"[а-яё+]+", token):
            raise ValueError(f"ru_stress: malformed stem token {token!r}")
        if token.count("+") != 1:
            raise ValueError(f"ru_stress: need exactly one '+': {token!r}")
        if token.endswith("+"):
            stem = token[:-1]
            if not _VOWEL_RE.search(stem):
                raise ValueError(f"ru_stress: vowelless E stem {token!r}")
            out[stem] = _END_STRESSED
        else:
            stem, idx = _accent_to_index(token)
            out[stem] = idx
    return out


EXACT = _parse_exact(_EXACT_RAW)
STEMS = _parse_stems(_STEM_RAW)
# plain-ё forms skipped by _parse_exact (layer 1 stresses them); ru.py's
# ё-restoration uses these as known ё spellings
YO_FORMS = frozenset(
    t for t in _EXACT_RAW.split() if "ё" in t and "+" not in t
)
_ENDINGS_BY_LEN = sorted(set(_ENDINGS), key=len, reverse=True)

# Adjectival 2-vowel endings trigger the antepenult default (но́вая,
# но́вого) — single-vowel forms of the same lemmas still hit penult,
# which is the same syllable.
_ADJ_2V = re.compile(
    r"[бвгджзклмнпрстфхцчшщ]"
    r"(?:ая|яя|ое|ее|ие|ые|ую|юю|ого|его|ому|ему|ыми|ими)$"
)


def _vowel_count(word: str) -> int:
    return len(_VOWEL_RE.findall(word))


def stress_index(word: str, n_vowels: int) -> typing.Optional[int]:
    """Ordinal (0-based, among the word's vowels) of the stressed vowel.

    ``None`` means the word is an unstressed clitic.  ``n_vowels`` is
    the caller's phoneme-space vowel count; when it disagrees with the
    orthographic count (non-Cyrillic input), only the position-free
    defaults are applied.
    """
    if n_vowels <= 0:
        return None
    w = word.lower()

    ortho_n = _vowel_count(w)
    if ortho_n != n_vowels:
        return 0 if n_vowels == 1 else n_vowels - 2

    # layer 1: ё
    for i, m in enumerate(_VOWEL_RE.finditer(w)):
        if m.group() == "ё":
            return i

    if w in CLITICS:
        return None

    # layer 2: exact forms
    hit = EXACT.get(w)
    if hit is not None:
        return min(hit, n_vowels - 1)

    # teen numerals and their ordinals keep the cardinal's stress in
    # every inflection: двена́дцатый, девятна́дцатом — the а of
    # -на́дцат-, except оди́ннадцат- (the и before)
    i = w.find("надцат")
    if i > 0:
        j = w.find("иннадцат")
        pos = j if j >= 0 else i + 1
        return len(_VOWEL_RE.findall(w[:pos]))

    # layer 3: stems (reflexive stripped first)
    base = w
    if len(base) > 4 and (base.endswith("ся") or base.endswith("сь")):
        base = base[:-2]
    for ending in _ENDINGS_BY_LEN:
        if ending and not base.endswith(ending):
            continue
        stem = base[: len(base) - len(ending)] if ending else base
        cls = STEMS.get(stem)
        if cls is None:
            continue
        stem_vowels = _vowel_count(stem)
        if cls == _END_STRESSED:
            if _VOWEL_RE.search(ending):
                return min(stem_vowels, n_vowels - 1)
            return max(stem_vowels - 1, 0)
        return min(cls, n_vowels - 1)

    # layer 4: derivational suffixes
    for rule in _SUFFIX_RULES:
        m = rule.search(w)
        if m:
            return min(_vowel_count(w[: m.start(1)]), n_vowels - 1)

    # layer 5: defaults
    if n_vowels == 1:
        return 0
    if n_vowels >= 3 and _ADJ_2V.search(w):
        return n_vowels - 3
    return n_vowels - 2
