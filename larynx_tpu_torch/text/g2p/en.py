# Copied from larynx_tpu/text/g2p/en.py; only the package name in its imports differs.
"""English (US) grapheme-to-phoneme: embedded lexicon + letter-to-sound rules.

Phoneme inventory matches the shipped en-us voices
(local/en-us/*/phonemes.txt): vowels aɪ aʊ eɪ i oʊ u æ ɑ ɔ ɔɪ ə ɚ ɛ ɪ ʊ ʌ,
consonants b d d͡ʒ f h j k l m n ŋ p s t t͡ʃ v w z ð ɡ ɹ ʃ ʒ θ; primary
and secondary  stress are prefixed to the vowel symbol (split later by
phonemes_to_ids' ``separate`` handling).

Pronunciations for the embedded lexicon follow General American
conventions; OOV words fall through to an ordered rule engine.
"""

import re
import typing

from larynx_tpu_torch.text.g2p.rules import acronym_readable as _rules_acronym_readable

# Lexicon: word -> space-separated phonemes (stress attached to the vowel).
_LEXICON_RAW = """
a ə
about ə b ˈaʊ t
above ə b ˈʌ v
across ə k ɹ ˈɔ s
act ˈæ k t
actually ˈæ k t͡ʃ u ə l i
add ˈæ d
after ˈæ f t ɚ
again ə ɡ ˈɛ n
against ə ɡ ˈɛ n s t
age ˈeɪ d͡ʒ
ago ə ɡ ˈoʊ
air ˈɛ ɹ
all ˈɔ l
almost ˈɔ l m oʊ s t
alone ə l ˈoʊ n
along ə l ˈɔ ŋ
already ɔ l ɹ ˈɛ d i
also ˈɔ l s oʊ
although ɔ l ð ˈoʊ
always ˈɔ l w eɪ z
am ˈæ m
among ə m ˈʌ ŋ
an ə n
and ə n d
animal ˈæ n ə m ə l
another ə n ˈʌ ð ɚ
answer ˈæ n s ɚ
any ˈɛ n i
anything ˈɛ n i θ ˌɪ ŋ
apple ˈæ p ə l
are ˈɑ ɹ
area ˈɛ ɹ i ə
arm ˈɑ ɹ m
around ə ɹ ˈaʊ n d
arthur ˈɑ ɹ θ ɚ
as ˈæ z
ask ˈæ s k
at ˈæ t
away ə w ˈeɪ
baby b ˈeɪ b i
back b ˈæ k
bad b ˈæ d
ball b ˈɔ l
be b ˈi
bear b ˈɛ ɹ
beautiful b j ˈu t ə f ə l
became b ɪ k ˈeɪ m
because b ɪ k ˈɔ z
become b ɪ k ˈʌ m
bed b ˈɛ d
been b ˈɪ n
before b ɪ f ˈɔ ɹ
began b ɪ ɡ ˈæ n
begin b ɪ ɡ ˈɪ n
behind b ɪ h ˈaɪ n d
beige b ˈeɪ ʒ
being b ˈi ɪ ŋ
believe b ɪ l ˈi v
below b ɪ l ˈoʊ
best b ˈɛ s t
better b ˈɛ t ɚ
between b ɪ t w ˈi n
big b ˈɪ ɡ
bird b ˈɚ d
black b l ˈæ k
blue b l ˈu
boat b ˈoʊ t
body b ˈɑ d i
book b ˈʊ k
both b ˈoʊ θ
box b ˈɑ k s
boy b ˈɔɪ
bring b ɹ ˈɪ ŋ
brought b ɹ ˈɔ t
build b ˈɪ l d
but b ˈʌ t
buy b ˈaɪ
by b ˈaɪ
cake k ˈeɪ k
call k ˈɔ l
came k ˈeɪ m
can k ˈæ n
cannot k ˈæ n ˌɑ t
car k ˈɑ ɹ
care k ˈɛ ɹ
carry k ˈæ ɹ i
cat k ˈæ t
catch k ˈæ t͡ʃ
cause k ˈɔ z
certain s ˈɚ t ə n
chance t͡ʃ ˈæ n s
change t͡ʃ ˈeɪ n d͡ʒ
check t͡ʃ ˈɛ k
child t͡ʃ ˈaɪ l d
children t͡ʃ ˈɪ l d ɹ ə n
city s ˈɪ t i
class k l ˈæ s
clear k l ˈɪ ɹ
close k l ˈoʊ s
cold k ˈoʊ l d
color k ˈʌ l ɚ
come k ˈʌ m
common k ˈɑ m ə n
complete k ə m p l ˈi t
computer k ə m p j ˈu t ɚ
could k ˈʊ d
country k ˈʌ n t ɹ i
course k ˈɔ ɹ s
cut k ˈʌ t
dark d ˈɑ ɹ k
dave d ˈeɪ v
day d ˈeɪ
deep d ˈi p
delicious d ɪ l ˈɪ ʃ ə s
develop d ɪ v ˈɛ l ə p
did d ˈɪ d
didn't d ˈɪ d ə n t
different d ˈɪ f ɹ ə n t
do d ˈu
does d ˈʌ z
dog d ˈɔ ɡ
don't d ˈoʊ n t
done d ˈʌ n
door d ˈɔ ɹ
down d ˈaʊ n
draw d ɹ ˈɔ
dry d ɹ ˈaɪ
during d ˈʊ ɹ ɪ ŋ
each ˈi t͡ʃ
early ˈɚ l i
earth ˈɚ θ
easy ˈi z i
eat ˈi t
echo ˈɛ k oʊ
eight ˈeɪ t
eighteen ˌeɪ t ˈi n
eighty ˈeɪ t i
either ˈi ð ɚ
eleven ɪ l ˈɛ v ə n
else ˈɛ l s
end ˈɛ n d
enough ɪ n ˈʌ f
even ˈi v ə n
evening ˈi v n ɪ ŋ
ever ˈɛ v ɚ
every ˈɛ v ɹ i
example ɪ ɡ z ˈæ m p ə l
eye ˈaɪ
face f ˈeɪ s
fact f ˈæ k t
family f ˈæ m ə l i
far f ˈɑ ɹ
fast f ˈæ s t
father f ˈɑ ð ɚ
feel f ˈi l
feet f ˈi t
fell f ˈɛ l
few f j ˈu
field f ˈi l d
fifteen f ˌɪ f t ˈi n
fifty f ˈɪ f t i
find f ˈaɪ n d
fine f ˈaɪ n
fire f ˈaɪ ɚ
first f ˈɚ s t
fish f ˈɪ ʃ
five f ˈaɪ v
fly f l ˈaɪ
follow f ˈɑ l oʊ
food f ˈu d
foot f ˈʊ t
for f ˈɔ ɹ
form f ˈɔ ɹ m
forty f ˈɔ ɹ t i
found f ˈaʊ n d
four f ˈɔ ɹ
fourteen f ˌɔ ɹ t ˈi n
free f ɹ ˈi
french f ɹ ˈɛ n t͡ʃ
friend f ɹ ˈɛ n d
from f ɹ ˈʌ m
front f ɹ ˈʌ n t
full f ˈʊ l
gave ɡ ˈeɪ v
get ɡ ˈɛ t
girl ɡ ˈɚ l
give ɡ ˈɪ v
go ɡ ˈoʊ
good ɡ ˈʊ d
got ɡ ˈɑ t
great ɡ ɹ ˈeɪ t
green ɡ ɹ ˈi n
ground ɡ ɹ ˈaʊ n d
group ɡ ɹ ˈu p
grow ɡ ɹ ˈoʊ
had h ˈæ d
half h ˈæ f
hand h ˈæ n d
happy h ˈæ p i
hard h ˈɑ ɹ d
has h ˈæ z
have h ˈæ v
he h ˈi
head h ˈɛ d
hear h ˈɪ ɹ
heard h ˈɚ d
heavy h ˈɛ v i
hello h ə l ˈoʊ
help h ˈɛ l p
her h ˈɚ
here h ˈɪ ɹ
high h ˈaɪ
him h ˈɪ m
his h ˈɪ z
hold h ˈoʊ l d
home h ˈoʊ m
horse h ˈɔ ɹ s
hot h ˈɑ t
hour ˈaʊ ɚ
house h ˈaʊ s
how h ˈaʊ
however h aʊ ˈɛ v ɚ
hue h j ˈu
hundred h ˈʌ n d ɹ ə d
i ˈaɪ
i'll ˈaɪ l
i'm ˈaɪ m
i've ˈaɪ v
idea aɪ d ˈi ə
if ˈɪ f
impressed ɪ m p ɹ ˈɛ s t
in ˈɪ n
including ɪ n k l ˈu d ɪ ŋ
into ˈɪ n t u
is ˈɪ z
it ˈɪ t
it's ˈɪ t s
its ˈɪ t s
just d͡ʒ ˈʌ s t
keep k ˈi p
kind k ˈaɪ n d
king k ˈɪ ŋ
knew n ˈu
know n ˈoʊ
known n ˈoʊ n
land l ˈæ n d
language l ˈæ ŋ ɡ w ə d͡ʒ
large l ˈɑ ɹ d͡ʒ
last l ˈæ s t
late l ˈeɪ t
later l ˈeɪ t ɚ
learn l ˈɚ n
leave l ˈi v
left l ˈɛ f t
less l ˈɛ s
let l ˈɛ t
letter l ˈɛ t ɚ
life l ˈaɪ f
light l ˈaɪ t
like l ˈaɪ k
line l ˈaɪ n
list l ˈɪ s t
listen l ˈɪ s ə n
little l ˈɪ t ə l
live l ˈɪ v
loch l ˈɑ k
long l ˈɔ ŋ
look l ˈʊ k
love l ˈʌ v
low l ˈoʊ
machine m ə ʃ ˈi n
made m ˈeɪ d
make m ˈeɪ k
man m ˈæ n
many m ˈɛ n i
may m ˈeɪ
me m ˈi
mean m ˈi n
men m ˈɛ n
might m ˈaɪ t
mile m ˈaɪ l
million m ˈɪ l j ə n
mind m ˈaɪ n d
minute m ˈɪ n ə t
miss m ˈɪ s
moist m ˈɔɪ s t
money m ˈʌ n i
month m ˈʌ n θ
moon m ˈu n
more m ˈɔ ɹ
morning m ˈɔ ɹ n ɪ ŋ
most m ˈoʊ s t
mother m ˈʌ ð ɚ
mountain m ˈaʊ n t ə n
move m ˈu v
much m ˈʌ t͡ʃ
music m j ˈu z ɪ k
must m ˈʌ s t
my m ˈaɪ
name n ˈeɪ m
near n ˈɪ ɹ
need n ˈi d
never n ˈɛ v ɚ
new n ˈu
next n ˈɛ k s t
night n ˈaɪ t
nine n ˈaɪ n
nineteen n ˌaɪ n t ˈi n
ninety n ˈaɪ n t i
no n ˈoʊ
north n ˈɔ ɹ θ
not n ˈɑ t
nothing n ˈʌ θ ɪ ŋ
november n oʊ v ˈɛ m b ɚ
now n ˈaʊ
number n ˈʌ m b ɚ
of ˈʌ v
off ˈɔ f
often ˈɔ f ə n
oh ˈoʊ
old ˈoʊ l d
on ˈɑ n
once w ˈʌ n s
one w ˈʌ n
only ˈoʊ n l i
open ˈoʊ p ə n
or ˈɔ ɹ
order ˈɔ ɹ d ɚ
other ˈʌ ð ɚ
our ˈaʊ ɚ
out ˈaʊ t
over ˈoʊ v ɚ
own ˈoʊ n
page p ˈeɪ d͡ʒ
paper p ˈeɪ p ɚ
part p ˈɑ ɹ t
people p ˈi p ə l
perhaps p ɚ h ˈæ p s
person p ˈɚ s ə n
picture p ˈɪ k t͡ʃ ɚ
piece p ˈi s
place p l ˈeɪ s
plant p l ˈæ n t
play p l ˈeɪ
point p ˈɔɪ n t
prior p ɹ ˈaɪ ɚ
put p ˈʊ t
queen k w ˈi n
question k w ˈɛ s t͡ʃ ə n
quick k w ˈɪ k
quickly k w ˈɪ k l i
quite k w ˈaɪ t
rain ɹ ˈeɪ n
ran ɹ ˈæ n
read ɹ ˈi d
ready ɹ ˈɛ d i
real ɹ ˈi l
really ɹ ˈɪ l i
red ɹ ˈɛ d
remember ɹ ɪ m ˈɛ m b ɚ
rest ɹ ˈɛ s t
right ɹ ˈaɪ t
river ɹ ˈɪ v ɚ
road ɹ ˈoʊ d
rock ɹ ˈɑ k
room ɹ ˈu m
round ɹ ˈaʊ n d
run ɹ ˈʌ n
said s ˈɛ d
same s ˈeɪ m
saw s ˈɔ
say s ˈeɪ
says s ˈɛ z
hatred h ˈeɪ t ɹ ɪ d
school s k ˈu l
sea s ˈi
second s ˈɛ k ə n d
see s ˈi
seem s ˈi m
seen s ˈi n
sentence s ˈɛ n t ə n s
set s ˈɛ t
seven s ˈɛ v ə n
seventeen s ˌɛ v ə n t ˈi n
seventy s ˈɛ v ə n t i
she ʃ ˈi
ship ʃ ˈɪ p
short ʃ ˈɔ ɹ t
should ʃ ˈʊ d
show ʃ ˈoʊ
side s ˈaɪ d
since s ˈɪ n s
sing s ˈɪ ŋ
six s ˈɪ k s
sixteen s ˌɪ k s t ˈi n
sixty s ˈɪ k s t i
sleep s l ˈi p
slow s l ˈoʊ
small s m ˈɔ l
so s ˈoʊ
some s ˈʌ m
something s ˈʌ m θ ɪ ŋ
song s ˈɔ ŋ
soon s ˈu n
sorry s ˈɑ ɹ i
sound s ˈaʊ n d
south s ˈaʊ θ
speak s p ˈi k
speech s p ˈi t͡ʃ
stand s t ˈæ n d
star s t ˈɑ ɹ
start s t ˈɑ ɹ t
state s t ˈeɪ t
stay s t ˈeɪ
still s t ˈɪ l
stop s t ˈɑ p
story s t ˈɔ ɹ i
street s t ɹ ˈi t
strong s t ɹ ˈɔ ŋ
study s t ˈʌ d i
such s ˈʌ t͡ʃ
sun s ˈʌ n
sure ʃ ˈʊ ɹ
symphony s ˈɪ m f ə n i
synthesis s ˈɪ n θ ə s ə s
system s ˈɪ s t ə m
take t ˈeɪ k
talk t ˈɔ k
tell t ˈɛ l
ten t ˈɛ n
test t ˈɛ s t
text t ˈɛ k s t
than ð ˈæ n
that ð ˈæ t
the ð ə
their ð ˈɛ ɹ
them ð ˈɛ m
then ð ˈɛ n
there ð ˈɛ ɹ
these ð ˈi z
they ð ˈeɪ
thing θ ˈɪ ŋ
think θ ˈɪ ŋ k
thirteen θ ˌɚ t ˈi n
thirty θ ˈɚ t i
this ð ˈɪ s
those ð ˈoʊ z
thought θ ˈɔ t
thousand θ ˈaʊ z ə n d
three θ ɹ ˈi
through θ ɹ ˈu
time t ˈaɪ m
to t ˈu
today t ə d ˈeɪ
together t ə ɡ ˈɛ ð ɚ
told t ˈoʊ l d
too t ˈu
took t ˈʊ k
top t ˈɑ p
toward t ə w ˈɔ ɹ d
town t ˈaʊ n
tree t ɹ ˈi
try t ɹ ˈaɪ
turn t ˈɚ n
twelve t w ˈɛ l v
twenty t w ˈɛ n t i
two t ˈu
under ˈʌ n d ɚ
until ə n t ˈɪ l
up ˈʌ p
upon ə p ˈɑ n
us ˈʌ s
use j ˈu z
used j ˈu z d
very v ˈɛ ɹ i
voice v ˈɔɪ s
wait w ˈeɪ t
walk w ˈɔ k
want w ˈɑ n t
wanted w ˈɑ n t ə d
warm w ˈɔ ɹ m
was w ˈʌ z
watch w ˈɑ t͡ʃ
water w ˈɔ t ɚ
waters w ˈɔ t ɚ z
way w ˈeɪ
we w ˈi
weather w ˈɛ ð ɚ
week w ˈi k
well w ˈɛ l
went w ˈɛ n t
were w ˈɚ
what w ˈʌ t
when w ˈɛ n
where w ˈɛ ɹ
which w ˈɪ t͡ʃ
while w ˈaɪ l
white w ˈaɪ t
who h ˈu
whole h ˈoʊ l
why w ˈaɪ
will w ˈɪ l
wind w ˈɪ n d
with w ˈɪ ð
without w ɪ θ ˈaʊ t
woman w ˈʊ m ə n
women w ˈɪ m ə n
word w ˈɚ d
words w ˈɚ d z
work w ˈɚ k
world w ˈɚ l d
would w ˈʊ d
write ɹ ˈaɪ t
year j ˈɪ ɹ
years j ˈɪ ɹ z
yes j ˈɛ s
yet j ˈɛ t
you j ˈu
young j ˈʌ ŋ
your j ˈɔ ɹ
zero z ˈɪ ɹ oʊ
afraid ə f ɹ ˈeɪ d
can't k ˈæ n t
silent s ˈaɪ l ə n t
going ɡ ˈoʊ ɪ ŋ
able ˈeɪ b ə l
accept æ k s ˈɛ p t
access ˈæ k s ɛ s
account ə k ˈaʊ n t
action ˈæ k ʃ ə n
active ˈæ k t ɪ v
address ə d ɹ ˈɛ s
admit æ d m ˈɪ t
adult ə d ˈʌ l t
affect ə f ˈɛ k t
afternoon ˌæ f t ɚ n ˈu n
agency ˈeɪ d͡ʒ ə n s i
agent ˈeɪ d͡ʒ ə n t
agree ə ɡ ɹ ˈi
ahead ə h ˈɛ d
allow ə l ˈaʊ
alright ɔ l ɹ ˈaɪ t
amazing ə m ˈeɪ z ɪ ŋ
america ə m ˈɛ ɹ ɪ k ə
american ə m ˈɛ ɹ ɪ k ə n
amount ə m ˈaʊ n t
analysis ə n ˈæ l ə s ə s
ancient ˈeɪ n ʃ ə n t
anger ˈæ ŋ ɡ ɚ
angle ˈæ ŋ ɡ ə l
angry ˈæ ŋ ɡ ɹ i
announce ə n ˈaʊ n s
annual ˈæ n j u ə l
anybody ˈɛ n i b ˌɑ d i
anymore ˌɛ n i m ˈɔ ɹ
anyone ˈɛ n i w ˌʌ n
anyway ˈɛ n i w ˌeɪ
anywhere ˈɛ n i w ˌɛ ɹ
apart ə p ˈɑ ɹ t
apartment ə p ˈɑ ɹ t m ə n t
appear ə p ˈɪ ɹ
application ˌæ p l ə k ˈeɪ ʃ ə n
apply ə p l ˈaɪ
approach ə p ɹ ˈoʊ t͡ʃ
april ˈeɪ p ɹ ə l
argue ˈɑ ɹ ɡ j u
argument ˈɑ ɹ ɡ j ə m ə n t
arrive ə ɹ ˈaɪ v
art ˈɑ ɹ t
article ˈɑ ɹ t ɪ k ə l
artist ˈɑ ɹ t ə s t
attack ə t ˈæ k
attempt ə t ˈɛ m p t
attention ə t ˈɛ n ʃ ə n
audio ˈɔ d i ˌoʊ
august ˈɔ ɡ ə s t
author ˈɔ θ ɚ
available ə v ˈeɪ l ə b ə l
average ˈæ v ɹ ə d͡ʒ
avoid ə v ˈɔɪ d
aware ə w ˈɛ ɹ
bag b ˈæ ɡ
balance b ˈæ l ə n s
band b ˈæ n d
bank b ˈæ ŋ k
bar b ˈɑ ɹ
base b ˈeɪ s
basic b ˈeɪ s ɪ k
basis b ˈeɪ s ə s
battle b ˈæ t ə l
beach b ˈi t͡ʃ
beat b ˈi t
beauty b j ˈu t i
becomes b ɪ k ˈʌ m z
beginning b ɪ ɡ ˈɪ n ɪ ŋ
behavior b ɪ h ˈeɪ v j ɚ
bell b ˈɛ l
belong b ɪ l ˈɔ ŋ
beneath b ɪ n ˈi θ
benefit b ˈɛ n ə f ɪ t
beside b ɪ s ˈaɪ d
besides b ɪ s ˈaɪ d z
beyond b i ˈɑ n d
bill b ˈɪ l
billion b ˈɪ l j ə n
bit b ˈɪ t
block b l ˈɑ k
blood b l ˈʌ d
board b ˈɔ ɹ d
bone b ˈoʊ n
border b ˈɔ ɹ d ɚ
born b ˈɔ ɹ n
bottle b ˈɑ t ə l
bottom b ˈɑ t ə m
brain b ɹ ˈeɪ n
branch b ɹ ˈæ n t͡ʃ
bread b ɹ ˈɛ d
break b ɹ ˈeɪ k
breakfast b ɹ ˈɛ k f ə s t
breath b ɹ ˈɛ θ
breathe b ɹ ˈi ð
bridge b ɹ ˈɪ d͡ʒ
brief b ɹ ˈi f
bright b ɹ ˈaɪ t
brother b ɹ ˈʌ ð ɚ
brown b ɹ ˈaʊ n
budget b ˈʌ d͡ʒ ə t
building b ˈɪ l d ɪ ŋ
burn b ˈɚ n
business b ˈɪ z n ə s
busy b ˈɪ z i
button b ˈʌ t ə n
camera k ˈæ m ɹ ə
campaign k æ m p ˈeɪ n
cancer k ˈæ n s ɚ
candidate k ˈæ n d ə d ə t
capital k ˈæ p ə t ə l
captain k ˈæ p t ə n
card k ˈɑ ɹ d
career k ə ɹ ˈɪ ɹ
careful k ˈɛ ɹ f ə l
cast k ˈæ s t
cell s ˈɛ l
center s ˈɛ n t ɚ
central s ˈɛ n t ɹ ə l
century s ˈɛ n t͡ʃ ɚ i
ceremony s ˈɛ ɹ ə m ˌoʊ n i
chair t͡ʃ ˈɛ ɹ
challenge t͡ʃ ˈæ l ə n d͡ʒ
champion t͡ʃ ˈæ m p i ə n
character k ˈɛ ɹ ə k t ɚ
charge t͡ʃ ˈɑ ɹ d͡ʒ
chart t͡ʃ ˈɑ ɹ t
cheap t͡ʃ ˈi p
chicken t͡ʃ ˈɪ k ə n
chief t͡ʃ ˈi f
choice t͡ʃ ˈɔɪ s
choose t͡ʃ ˈu z
chose t͡ʃ ˈoʊ z
church t͡ʃ ˈɚ t͡ʃ
circle s ˈɚ k ə l
citizen s ˈɪ t ə z ə n
claim k l ˈeɪ m
clean k l ˈi n
click k l ˈɪ k
climb k l ˈaɪ m
clock k l ˈɑ k
closed k l ˈoʊ z d
clothes k l ˈoʊ z
cloud k l ˈaʊ d
club k l ˈʌ b
coach k ˈoʊ t͡ʃ
coast k ˈoʊ s t
coffee k ˈɔ f i
collect k ə l ˈɛ k t
college k ˈɑ l ɪ d͡ʒ
command k ə m ˈæ n d
comment k ˈɑ m ɛ n t
community k ə m j ˈu n ə t i
company k ˈʌ m p ə n i
compare k ə m p ˈɛ ɹ
concern k ə n s ˈɚ n
condition k ə n d ˈɪ ʃ ə n
conference k ˈɑ n f ɹ ə n s
congress k ˈɑ ŋ ɡ ɹ ə s
connect k ə n ˈɛ k t
consider k ə n s ˈɪ d ɚ
contain k ə n t ˈeɪ n
continue k ə n t ˈɪ n j u
control k ə n t ɹ ˈoʊ l
conversation k ˌɑ n v ɚ s ˈeɪ ʃ ə n
cook k ˈʊ k
cool k ˈu l
copy k ˈɑ p i
corn k ˈɔ ɹ n
corner k ˈɔ ɹ n ɚ
correct k ə ɹ ˈɛ k t
cost k ˈɔ s t
cotton k ˈɑ t ə n
couch k ˈaʊ t͡ʃ
couple k ˈʌ p ə l
courage k ˈɚ ə d͡ʒ
court k ˈɔ ɹ t
cover k ˈʌ v ɚ
cow k ˈaʊ
create k ɹ i ˈeɪ t
credit k ɹ ˈɛ d ə t
crew k ɹ ˈu
crime k ɹ ˈaɪ m
cross k ɹ ˈɔ s
crowd k ɹ ˈaʊ d
cry k ɹ ˈaɪ
culture k ˈʌ l t͡ʃ ɚ
cup k ˈʌ p
current k ˈɚ ə n t
customer k ˈʌ s t ə m ɚ
cycle s ˈaɪ k ə l
damage d ˈæ m ə d͡ʒ
dance d ˈæ n s
danger d ˈeɪ n d͡ʒ ɚ
data d ˈeɪ t ə
date d ˈeɪ t
daughter d ˈɔ t ɚ
dead d ˈɛ d
deal d ˈi l
dear d ˈɪ ɹ
death d ˈɛ θ
debate d ə b ˈeɪ t
december d ɪ s ˈɛ m b ɚ
decide d ə s ˈaɪ d
decision d ə s ˈɪ ʒ ə n
defense d ɪ f ˈɛ n s
degree d ɪ ɡ ɹ ˈi
demand d ɪ m ˈæ n d
democracy d ɪ m ˈɑ k ɹ ə s i
describe d ɪ s k ɹ ˈaɪ b
design d ɪ z ˈaɪ n
desk d ˈɛ s k
despite d ɪ s p ˈaɪ t
detail d ˈi t eɪ l
determine d ɪ t ˈɚ m ə n
device d ɪ v ˈaɪ s
dialogue d ˈaɪ ə l ˌɔ ɡ
dictionary d ˈɪ k ʃ ə n ˌɛ ɹ i
die d ˈaɪ
difference d ˈɪ f ɹ ə n s
difficult d ˈɪ f ə k ə l t
digital d ˈɪ d͡ʒ ə t ə l
dinner d ˈɪ n ɚ
direction d ə ɹ ˈɛ k ʃ ə n
director d ə ɹ ˈɛ k t ɚ
discover d ɪ s k ˈʌ v ɚ
discuss d ɪ s k ˈʌ s
discussion d ɪ s k ˈʌ ʃ ə n
disease d ɪ z ˈi z
distance d ˈɪ s t ə n s
doctor d ˈɑ k t ɚ
document d ˈɑ k j ə m ə n t
dollar d ˈɑ l ɚ
double d ˈʌ b ə l
doubt d ˈaʊ t
dozen d ˈʌ z ə n
dream d ɹ ˈi m
dress d ɹ ˈɛ s
drink d ɹ ˈɪ ŋ k
drive d ɹ ˈaɪ v
driver d ɹ ˈaɪ v ɚ
drop d ɹ ˈɑ p
drug d ɹ ˈʌ ɡ
due d ˈu
dust d ˈʌ s t
duty d ˈu t i
eastern ˈi s t ɚ n
economy ɪ k ˈɑ n ə m i
edge ˈɛ d͡ʒ
education ˌɛ d͡ʒ ə k ˈeɪ ʃ ə n
effect ɪ f ˈɛ k t
effort ˈɛ f ɚ t
egg ˈɛ ɡ
election ɪ l ˈɛ k ʃ ə n
electric ɪ l ˈɛ k t ɹ ɪ k
email ˈi m eɪ l
emergency ɪ m ˈɚ d͡ʒ ə n s i
emotion ɪ m ˈoʊ ʃ ə n
employee ɛ m p l ˈɔɪ i
empty ˈɛ m p t i
energy ˈɛ n ɚ d͡ʒ i
engine ˈɛ n d͡ʒ ə n
english ˈɪ ŋ ɡ l ɪ ʃ
enjoy ɛ n d͡ʒ ˈɔɪ
enter ˈɛ n t ɚ
entire ɛ n t ˈaɪ ɚ
environment ɛ n v ˈaɪ ɹ ə n m ə n t
equal ˈi k w ə l
equipment ɪ k w ˈɪ p m ə n t
error ˈɛ ɹ ɚ
escape ɪ s k ˈeɪ p
especially ɪ s p ˈɛ ʃ ə l i
establish ɪ s t ˈæ b l ɪ ʃ
europe j ˈʊ ɹ ə p
event ɪ v ˈɛ n t
everybody ˈɛ v ɹ i b ˌɑ d i
everyone ˈɛ v ɹ i w ˌʌ n
everything ˈɛ v ɹ i θ ˌɪ ŋ
everywhere ˈɛ v ɹ i w ˌɛ ɹ
evidence ˈɛ v ə d ə n s
exact ɪ ɡ z ˈæ k t
exactly ɪ ɡ z ˈæ k t l i
examine ɪ ɡ z ˈæ m ə n
excellent ˈɛ k s ə l ə n t
except ɪ k s ˈɛ p t
exchange ɪ k s t͡ʃ ˈeɪ n d͡ʒ
excite ɪ k s ˈaɪ t
exercise ˈɛ k s ɚ s ˌaɪ z
exist ɪ ɡ z ˈɪ s t
expect ɪ k s p ˈɛ k t
expensive ɪ k s p ˈɛ n s ɪ v
experience ɪ k s p ˈɪ ɹ i ə n s
experiment ɪ k s p ˈɛ ɹ ə m ə n t
expert ˈɛ k s p ɚ t
explain ɪ k s p l ˈeɪ n
express ɪ k s p ɹ ˈɛ s
extra ˈɛ k s t ɹ ə
factor f ˈæ k t ɚ
factory f ˈæ k t ɚ i
fail f ˈeɪ l
fair f ˈɛ ɹ
faith f ˈeɪ θ
fall f ˈɔ l
false f ˈɔ l s
familiar f ə m ˈɪ l j ɚ
famous f ˈeɪ m ə s
fan f ˈæ n
farm f ˈɑ ɹ m
farmer f ˈɑ ɹ m ɚ
fashion f ˈæ ʃ ə n
fat f ˈæ t
fear f ˈɪ ɹ
feature f ˈi t͡ʃ ɚ
february f ˈɛ b j u ˌɛ ɹ i
federal f ˈɛ d ɚ ə l
feed f ˈi d
feeling f ˈi l ɪ ŋ
fight f ˈaɪ t
figure f ˈɪ ɡ j ɚ
file f ˈaɪ l
fill f ˈɪ l
film f ˈɪ l m
final f ˈaɪ n ə l
finally f ˈaɪ n ə l i
finance f ə n ˈæ n s
finger f ˈɪ ŋ ɡ ɚ
finish f ˈɪ n ɪ ʃ
firm f ˈɚ m
fit f ˈɪ t
fix f ˈɪ k s
flat f l ˈæ t
flight f l ˈaɪ t
floor f l ˈɔ ɹ
flow f l ˈoʊ
flower f l ˈaʊ ɚ
focus f ˈoʊ k ə s
forest f ˈɔ ɹ ə s t
forever f ə ɹ ˈɛ v ɚ
forget f ɚ ɡ ˈɛ t
forward f ˈɔ ɹ w ɚ d
frame f ɹ ˈeɪ m
france f ɹ ˈæ n s
fresh f ɹ ˈɛ ʃ
friday f ɹ ˈaɪ d eɪ
fruit f ɹ ˈu t
fun f ˈʌ n
function f ˈʌ ŋ k ʃ ə n
fund f ˈʌ n d
future f j ˈu t͡ʃ ɚ
game ɡ ˈeɪ m
garden ɡ ˈɑ ɹ d ə n
gas ɡ ˈæ s
gather ɡ ˈæ ð ɚ
general d͡ʒ ˈɛ n ɚ ə l
generation d͡ʒ ˌɛ n ə ɹ ˈeɪ ʃ ə n
gentle d͡ʒ ˈɛ n t ə l
german d͡ʒ ˈɚ m ə n
germany d͡ʒ ˈɚ m ə n i
gift ɡ ˈɪ f t
glad ɡ l ˈæ d
glass ɡ l ˈæ s
global ɡ l ˈoʊ b ə l
goal ɡ ˈoʊ l
god ɡ ˈɑ d
gold ɡ ˈoʊ l d
gone ɡ ˈɔ n
government ɡ ˈʌ v ɚ n m ə n t
grand ɡ ɹ ˈæ n d
grass ɡ ɹ ˈæ s
gray ɡ ɹ ˈeɪ
grew ɡ ɹ ˈu
growth ɡ ɹ ˈoʊ θ
guard ɡ ˈɑ ɹ d
guess ɡ ˈɛ s
guest ɡ ˈɛ s t
guide ɡ ˈaɪ d
gun ɡ ˈʌ n
guy ɡ ˈaɪ
hair h ˈɛ ɹ
hall h ˈɔ l
handle h ˈæ n d ə l
hang h ˈæ ŋ
happen h ˈæ p ə n
happened h ˈæ p ə n d
harm h ˈɑ ɹ m
hate h ˈeɪ t
health h ˈɛ l θ
hearing h ˈɪ ɹ ɪ ŋ
heart h ˈɑ ɹ t
heat h ˈi t
herself h ɚ s ˈɛ l f
hide h ˈaɪ d
highway h ˈaɪ w eɪ
hill h ˈɪ l
himself h ɪ m s ˈɛ l f
history h ˈɪ s t ɚ i
hit h ˈɪ t
hole h ˈoʊ l
holiday h ˈɑ l ə d ˌeɪ
honest ˈɑ n ə s t
hope h ˈoʊ p
hospital h ˈɑ s p ɪ t ə l
host h ˈoʊ s t
hotel h oʊ t ˈɛ l
huge h j ˈu d͡ʒ
human h j ˈu m ə n
hurt h ˈɚ t
husband h ˈʌ z b ə n d
ice ˈaɪ s
image ˈɪ m ə d͡ʒ
imagine ɪ m ˈæ d͡ʒ ə n
impact ˈɪ m p æ k t
important ɪ m p ˈɔ ɹ t ə n t
improve ɪ m p ɹ ˈu v
inch ˈɪ n t͡ʃ
increase ɪ n k ɹ ˈi s
indeed ɪ n d ˈi d
industry ˈɪ n d ə s t ɹ i
information ˌɪ n f ɚ m ˈeɪ ʃ ə n
inside ɪ n s ˈaɪ d
instance ˈɪ n s t ə n s
instead ɪ n s t ˈɛ d
institution ˌɪ n s t ə t ˈu ʃ ə n
interest ˈɪ n t ɹ ə s t
interesting ˈɪ n t ɹ ə s t ɪ ŋ
international ˌɪ n t ɚ n ˈæ ʃ ə n ə l
internet ˈɪ n t ɚ n ˌɛ t
interview ˈɪ n t ɚ v j ˌu
introduce ˌɪ n t ɹ ə d ˈu s
investment ɪ n v ˈɛ s t m ə n t
involve ɪ n v ˈɑ l v
iron ˈaɪ ɚ n
island ˈaɪ l ə n d
issue ˈɪ ʃ u
item ˈaɪ t ə m
itself ɪ t s ˈɛ l f
january d͡ʒ ˈæ n j u ˌɛ ɹ i
job d͡ʒ ˈɑ b
join d͡ʒ ˈɔɪ n
joke d͡ʒ ˈoʊ k
journey d͡ʒ ˈɚ n i
joy d͡ʒ ˈɔɪ
judge d͡ʒ ˈʌ d͡ʒ
july d͡ʒ u l ˈaɪ
jump d͡ʒ ˈʌ m p
june d͡ʒ ˈu n
key k ˈi
kick k ˈɪ k
kid k ˈɪ d
kill k ˈɪ l
kitchen k ˈɪ t͡ʃ ə n
knee n ˈi
knife n ˈaɪ f
knock n ˈɑ k
knowledge n ˈɑ l ɪ d͡ʒ
lack l ˈæ k
lady l ˈeɪ d i
lake l ˈeɪ k
laugh l ˈæ f
law l ˈɔ
lawyer l ˈɔɪ ɚ
lay l ˈeɪ
lead l ˈi d
leader l ˈi d ɚ
leg l ˈɛ ɡ
legal l ˈi ɡ ə l
lesson l ˈɛ s ə n
level l ˈɛ v ə l
library l ˈaɪ b ɹ ˌɛ ɹ i
lie l ˈaɪ
limit l ˈɪ m ə t
link l ˈɪ ŋ k
lip l ˈɪ p
local l ˈoʊ k ə l
lock l ˈɑ k
lonely l ˈoʊ n l i
lose l ˈu z
loss l ˈɔ s
lost l ˈɔ s t
loud l ˈaʊ d
lucky l ˈʌ k i
lunch l ˈʌ n t͡ʃ
mail m ˈeɪ l
main m ˈeɪ n
maintain m eɪ n t ˈeɪ n
major m ˈeɪ d͡ʒ ɚ
majority m ə d͡ʒ ˈɔ ɹ ə t i
manage m ˈæ n ə d͡ʒ
manager m ˈæ n ə d͡ʒ ɚ
march m ˈɑ ɹ t͡ʃ
mark m ˈɑ ɹ k
market m ˈɑ ɹ k ə t
marriage m ˈɛ ɹ ɪ d͡ʒ
marry m ˈɛ ɹ i
mass m ˈæ s
master m ˈæ s t ɚ
match m ˈæ t͡ʃ
material m ə t ˈɪ ɹ i ə l
matter m ˈæ t ɚ
maybe m ˈeɪ b i
meal m ˈi l
measure m ˈɛ ʒ ɚ
meat m ˈi t
media m ˈi d i ə
medical m ˈɛ d ɪ k ə l
medicine m ˈɛ d ə s ə n
meet m ˈi t
meeting m ˈi t ɪ ŋ
member m ˈɛ m b ɚ
memory m ˈɛ m ɚ i
mention m ˈɛ n ʃ ə n
message m ˈɛ s ə d͡ʒ
metal m ˈɛ t ə l
method m ˈɛ θ ə d
middle m ˈɪ d ə l
midnight m ˈɪ d n aɪ t
military m ˈɪ l ə t ˌɛ ɹ i
milk m ˈɪ l k
mine m ˈaɪ n
minister m ˈɪ n ə s t ɚ
minor m ˈaɪ n ɚ
mirror m ˈɪ ɹ ɚ
missing m ˈɪ s ɪ ŋ
mission m ˈɪ ʃ ə n
mistake m ɪ s t ˈeɪ k
mix m ˈɪ k s
model m ˈɑ d ə l
modern m ˈɑ d ɚ n
moment m ˈoʊ m ə n t
monday m ˈʌ n d eɪ
mostly m ˈoʊ s t l i
mouth m ˈaʊ θ
movement m ˈu v m ə n t
movie m ˈu v i
mr m ˈɪ s t ɚ
mrs m ˈɪ s ə z
myself m aɪ s ˈɛ l f
narrow n ˈɛ ɹ oʊ
nation n ˈeɪ ʃ ə n
national n ˈæ ʃ ə n ə l
natural n ˈæ t͡ʃ ɚ ə l
nature n ˈeɪ t͡ʃ ɚ
nearly n ˈɪ ɹ l i
necessary n ˈɛ s ə s ˌɛ ɹ i
neck n ˈɛ k
neighbor n ˈeɪ b ɚ
neither n ˈi ð ɚ
nervous n ˈɚ v ə s
network n ˈɛ t w ɚ k
news n ˈu z
newspaper n ˈu z p eɪ p ɚ
nice n ˈaɪ s
nobody n ˈoʊ b ˌɑ d i
noise n ˈɔɪ z
none n ˈʌ n
noon n ˈu n
normal n ˈɔ ɹ m ə l
nose n ˈoʊ z
note n ˈoʊ t
notice n ˈoʊ t ə s
nurse n ˈɚ s
object ˈɑ b d͡ʒ ɛ k t
occur ə k ˈɚ
ocean ˈoʊ ʃ ə n
october ɑ k t ˈoʊ b ɚ
offer ˈɔ f ɚ
office ˈɔ f ə s
officer ˈɔ f ə s ɚ
official ə f ˈɪ ʃ ə l
oil ˈɔɪ l
okay oʊ k ˈeɪ
operation ˌɑ p ə ɹ ˈeɪ ʃ ə n
opinion ə p ˈɪ n j ə n
opportunity ˌɑ p ɚ t ˈu n ə t i
option ˈɑ p ʃ ə n
orange ˈɔ ɹ ə n d͡ʒ
organization ˌɔ ɹ ɡ ə n ə z ˈeɪ ʃ ə n
original ə ɹ ˈɪ d͡ʒ ə n ə l
others ˈʌ ð ɚ z
otherwise ˈʌ ð ɚ w ˌaɪ z
ourselves aʊ ɚ s ˈɛ l v z
outside aʊ t s ˈaɪ d
owner ˈoʊ n ɚ
pain p ˈeɪ n
paint p ˈeɪ n t
pair p ˈɛ ɹ
pants p ˈæ n t s
parent p ˈɛ ɹ ə n t
park p ˈɑ ɹ k
particular p ɚ t ˈɪ k j ə l ɚ
partner p ˈɑ ɹ t n ɚ
party p ˈɑ ɹ t i
pass p ˈæ s
passenger p ˈæ s ə n d͡ʒ ɚ
past p ˈæ s t
path p ˈæ θ
patient p ˈeɪ ʃ ə n t
pattern p ˈæ t ɚ n
pay p ˈeɪ
peace p ˈi s
pen p ˈɛ n
pencil p ˈɛ n s ə l
perfect p ˈɚ f ɪ k t
perform p ɚ f ˈɔ ɹ m
period p ˈɪ ɹ i ə d
personal p ˈɚ s ə n ə l
phone f ˈoʊ n
photo f ˈoʊ t oʊ
phrase f ɹ ˈeɪ z
physical f ˈɪ z ɪ k ə l
piano p i ˈæ n oʊ
pick p ˈɪ k
pink p ˈɪ ŋ k
plan p l ˈæ n
plane p l ˈeɪ n
planet p l ˈæ n ə t
plastic p l ˈæ s t ɪ k
plate p l ˈeɪ t
player p l ˈeɪ ɚ
please p l ˈi z
pleasure p l ˈɛ ʒ ɚ
pocket p ˈɑ k ə t
poem p ˈoʊ ə m
police p ə l ˈi s
policy p ˈɑ l ə s i
political p ə l ˈɪ t ɪ k ə l
politics p ˈɑ l ə t ɪ k s
pool p ˈu l
poor p ˈʊ ɹ
popular p ˈɑ p j ə l ɚ
population p ˌɑ p j ə l ˈeɪ ʃ ə n
position p ə z ˈɪ ʃ ə n
positive p ˈɑ z ə t ɪ v
possible p ˈɑ s ə b ə l
pound p ˈaʊ n d
power p ˈaʊ ɚ
powerful p ˈaʊ ɚ f ə l
practice p ɹ ˈæ k t ə s
prepare p ɹ ɪ p ˈɛ ɹ
present p ɹ ˈɛ z ə n t
president p ɹ ˈɛ z ə d ə n t
press p ɹ ˈɛ s
pressure p ɹ ˈɛ ʃ ɚ
pretty p ɹ ˈɪ t i
prevent p ɹ ɪ v ˈɛ n t
price p ɹ ˈaɪ s
pride p ɹ ˈaɪ d
private p ɹ ˈaɪ v ə t
prize p ɹ ˈaɪ z
probably p ɹ ˈɑ b ə b l i
problem p ɹ ˈɑ b l ə m
process p ɹ ˈɑ s ɛ s
produce p ɹ ə d ˈu s
product p ɹ ˈɑ d ə k t
professor p ɹ ə f ˈɛ s ɚ
program p ɹ ˈoʊ ɡ ɹ æ m
project p ɹ ˈɑ d͡ʒ ɛ k t
promise p ɹ ˈɑ m ə s
protect p ɹ ə t ˈɛ k t
proud p ɹ ˈaʊ d
prove p ɹ ˈu v
provide p ɹ ə v ˈaɪ d
public p ˈʌ b l ɪ k
pull p ˈʊ l
purpose p ˈɚ p ə s
push p ˈʊ ʃ
quality k w ˈɑ l ə t i
quarter k w ˈɔ ɹ t ɚ
quiet k w ˈaɪ ə t
race ɹ ˈeɪ s
radio ɹ ˈeɪ d i ˌoʊ
raise ɹ ˈeɪ z
range ɹ ˈeɪ n d͡ʒ
rate ɹ ˈeɪ t
rather ɹ ˈæ ð ɚ
reach ɹ ˈi t͡ʃ
reaction ɹ i ˈæ k ʃ ə n
reason ɹ ˈi z ə n
receive ɹ ə s ˈi v
recent ɹ ˈi s ə n t
recently ɹ ˈi s ə n t l i
recognize ɹ ˈɛ k ə ɡ n ˌaɪ z
record ɹ ˈɛ k ɚ d
reduce ɹ ɪ d ˈu s
reflect ɹ ɪ f l ˈɛ k t
region ɹ ˈi d͡ʒ ə n
relationship ɹ ɪ l ˈeɪ ʃ ə n ʃ ˌɪ p
release ɹ ɪ l ˈi s
religion ɹ ɪ l ˈɪ d͡ʒ ə n
remain ɹ ɪ m ˈeɪ n
remove ɹ ɪ m ˈu v
repeat ɹ ɪ p ˈi t
replace ɹ ɪ p l ˈeɪ s
report ɹ ɪ p ˈɔ ɹ t
represent ɹ ˌɛ p ɹ ɪ z ˈɛ n t
require ɹ ɪ k w ˈaɪ ɚ
research ɹ ˈi s ɚ t͡ʃ
reservoir ɹ ˈɛ z ɚ v w ˌɑ ɹ
resilience ɹ ɪ z ˈɪ l j ə n s
resilient ɹ ɪ z ˈɪ l j ə n t
ubiquitous j u b ˈɪ k w ɪ t ə s
ephemeral ɪ f ˈɛ m ɚ ə l
paradigm p ˈɛ ɹ ə d ˌaɪ m
bureaucrat b j ˈʊ ɹ ə k ɹ ˌæ t
bureaucratic b j ˌʊ ɹ ə k ɹ ˈæ t ɪ k
entrepreneurial ˌɑ n t ɹ ə p ɹ ə n ˈɚ i ə l
croissant k ɹ ə s ˈɑ n t
quinoa k ˈi n w ɑ
sriracha s ɪ ɹ ˈɑ t͡ʃ ə
kubernetes k ˌu b ɚ n ˈɛ t i z
massage m ə s ˈɑ ʒ
miniature m ˈɪ n i ə t͡ʃ ɚ
suite s w ˈi t
resource ɹ ˈi s ɔ ɹ s
respect ɹ ɪ s p ˈɛ k t
respond ɹ ɪ s p ˈɑ n d
response ɹ ɪ s p ˈɑ n s
responsibility ɹ ɪ s p ˌɑ n s ə b ˈɪ l ə t i
result ɹ ɪ z ˈʌ l t
return ɹ ɪ t ˈɚ n
reveal ɹ ɪ v ˈi l
review ɹ i v j ˈu
rich ɹ ˈɪ t͡ʃ
ride ɹ ˈaɪ d
ring ɹ ˈɪ ŋ
rise ɹ ˈaɪ z
risk ɹ ˈɪ s k
rule ɹ ˈu l
rush ɹ ˈʌ ʃ
sad s ˈæ d
safe s ˈeɪ f
safety s ˈeɪ f t i
salt s ˈɔ l t
sand s ˈæ n d
saturday s ˈæ t ɚ d eɪ
save s ˈeɪ v
scale s k ˈeɪ l
scene s ˈi n
science s ˈaɪ ə n s
scientist s ˈaɪ ə n t ə s t
score s k ˈɔ ɹ
screen s k ɹ ˈi n
search s ˈɚ t͡ʃ
season s ˈi z ə n
seat s ˈi t
secret s ˈi k ɹ ə t
section s ˈɛ k ʃ ə n
security s ɪ k j ˈʊ ɹ ə t i
sell s ˈɛ l
send s ˈɛ n d
senior s ˈi n j ɚ
sense s ˈɛ n s
separate s ˈɛ p ɚ ə t
september s ɛ p t ˈɛ m b ɚ
series s ˈɪ ɹ i z
serious s ˈɪ ɹ i ə s
serve s ˈɚ v
service s ˈɚ v ə s
settle s ˈɛ t ə l
several s ˈɛ v ɹ ə l
shake ʃ ˈeɪ k
shape ʃ ˈeɪ p
share ʃ ˈɛ ɹ
sharp ʃ ˈɑ ɹ p
shoe ʃ ˈu
shoot ʃ ˈu t
shop ʃ ˈɑ p
shoulder ʃ ˈoʊ l d ɚ
shout ʃ ˈaʊ t
sick s ˈɪ k
sign s ˈaɪ n
signal s ˈɪ ɡ n ə l
silence s ˈaɪ l ə n s
silver s ˈɪ l v ɚ
similar s ˈɪ m ə l ɚ
simple s ˈɪ m p ə l
single s ˈɪ ŋ ɡ ə l
sister s ˈɪ s t ɚ
sit s ˈɪ t
situation s ˌɪ t͡ʃ u ˈeɪ ʃ ə n
size s ˈaɪ z
skill s k ˈɪ l
skin s k ˈɪ n
sky s k ˈaɪ
smart s m ˈɑ ɹ t
smile s m ˈaɪ l
smoke s m ˈoʊ k
snow s n ˈoʊ
social s ˈoʊ ʃ ə l
society s ə s ˈaɪ ə t i
soft s ˈɔ f t
software s ˈɔ f t w ɛ ɹ
soil s ˈɔɪ l
soldier s ˈoʊ l d͡ʒ ɚ
solution s ə l ˈu ʃ ə n
solve s ˈɑ l v
somebody s ˈʌ m b ˌɑ d i
someone s ˈʌ m w ˌʌ n
somewhere s ˈʌ m w ˌɛ ɹ
son s ˈʌ n
sort s ˈɔ ɹ t
source s ˈɔ ɹ s
space s p ˈeɪ s
spanish s p ˈæ n ɪ ʃ
special s p ˈɛ ʃ ə l
specific s p ə s ˈɪ f ɪ k
spend s p ˈɛ n d
spirit s p ˈɪ ɹ ə t
sport s p ˈɔ ɹ t
spot s p ˈɑ t
spread s p ɹ ˈɛ d
spring s p ɹ ˈɪ ŋ
staff s t ˈæ f
stage s t ˈeɪ d͡ʒ
stair s t ˈɛ ɹ
standard s t ˈæ n d ɚ d
station s t ˈeɪ ʃ ə n
status s t ˈæ t ə s
step s t ˈɛ p
stick s t ˈɪ k
stock s t ˈɑ k
stone s t ˈoʊ n
store s t ˈɔ ɹ
storm s t ˈɔ ɹ m
straight s t ɹ ˈeɪ t
strange s t ɹ ˈeɪ n d͡ʒ
stream s t ɹ ˈi m
strength s t ɹ ˈɛ ŋ k θ
stress s t ɹ ˈɛ s
stretch s t ɹ ˈɛ t͡ʃ
strike s t ɹ ˈaɪ k
structure s t ɹ ˈʌ k t͡ʃ ɚ
student s t ˈu d ə n t
style s t ˈaɪ l
subject s ˈʌ b d͡ʒ ɪ k t
success s ə k s ˈɛ s
successful s ə k s ˈɛ s f ə l
sudden s ˈʌ d ə n
suddenly s ˈʌ d ə n l i
suffer s ˈʌ f ɚ
sugar ʃ ˈʊ ɡ ɚ
suggest s ə ɡ d͡ʒ ˈɛ s t
summer s ˈʌ m ɚ
sunday s ˈʌ n d eɪ
supply s ə p l ˈaɪ
support s ə p ˈɔ ɹ t
suppose s ə p ˈoʊ z
surface s ˈɚ f ə s
surprise s ɚ p ɹ ˈaɪ z
survive s ɚ v ˈaɪ v
sweet s w ˈi t
swim s w ˈɪ m
switch s w ˈɪ t͡ʃ
table t ˈeɪ b ə l
tail t ˈeɪ l
target t ˈɑ ɹ ɡ ə t
task t ˈæ s k
taste t ˈeɪ s t
tax t ˈæ k s
tea t ˈi
teach t ˈi t͡ʃ
teacher t ˈi t͡ʃ ɚ
team t ˈi m
technology t ɛ k n ˈɑ l ə d͡ʒ i
television t ˈɛ l ə v ˌɪ ʒ ə n
temperature t ˈɛ m p ɹ ə t͡ʃ ɚ
term t ˈɚ m
themselves ð ɛ m s ˈɛ l v z
theory θ ˈɪ ɹ i
therefore ð ˈɛ ɹ f ɔ ɹ
thick θ ˈɪ k
thin θ ˈɪ n
third θ ˈɚ d
threat θ ɹ ˈɛ t
throat θ ɹ ˈoʊ t
throughout θ ɹ u ˈaʊ t
throw θ ɹ ˈoʊ
thursday θ ˈɚ z d eɪ
ticket t ˈɪ k ə t
tie t ˈaɪ
tiny t ˈaɪ n i
tired t ˈaɪ ɚ d
title t ˈaɪ t ə l
tomorrow t ə m ˈɑ ɹ oʊ
tone t ˈoʊ n
tongue t ˈʌ ŋ
tonight t ə n ˈaɪ t
tool t ˈu l
tooth t ˈu θ
total t ˈoʊ t ə l
touch t ˈʌ t͡ʃ
tough t ˈʌ f
tour t ˈʊ ɹ
track t ɹ ˈæ k
trade t ɹ ˈeɪ d
tradition t ɹ ə d ˈɪ ʃ ə n
traffic t ɹ ˈæ f ɪ k
train t ɹ ˈeɪ n
training t ɹ ˈeɪ n ɪ ŋ
travel t ɹ ˈæ v ə l
treat t ɹ ˈi t
treatment t ɹ ˈi t m ə n t
trial t ɹ ˈaɪ ə l
trip t ɹ ˈɪ p
trouble t ɹ ˈʌ b ə l
truck t ɹ ˈʌ k
true t ɹ ˈu
trust t ɹ ˈʌ s t
truth t ɹ ˈu θ
tuesday t ˈu z d eɪ
type t ˈaɪ p
uncle ˈʌ ŋ k ə l
understand ˌʌ n d ɚ s t ˈæ n d
unit j ˈu n ə t
united j u n ˈaɪ t ə d
university j ˌu n ə v ˈɚ s ə t i
unless ə n l ˈɛ s
usual j ˈu ʒ u ə l
usually j ˈu ʒ u ə l i
value v ˈæ l j u
variety v ə ɹ ˈaɪ ə t i
various v ˈɛ ɹ i ə s
vehicle v ˈi ɪ k ə l
version v ˈɚ ʒ ə n
victory v ˈɪ k t ɚ i
video v ˈɪ d i ˌoʊ
view v j ˈu
village v ˈɪ l ɪ d͡ʒ
violence v ˈaɪ ə l ə n s
visit v ˈɪ z ə t
voter v ˈoʊ t ɚ
wall w ˈɔ l
war w ˈɔ ɹ
warn w ˈɔ ɹ n
wash w ˈɑ ʃ
waste w ˈeɪ s t
wave w ˈeɪ v
weapon w ˈɛ p ə n
wear w ˈɛ ɹ
wednesday w ˈɛ n z d eɪ
weight w ˈeɪ t
welcome w ˈɛ l k ə m
west w ˈɛ s t
western w ˈɛ s t ɚ n
wet w ˈɛ t
whatever w ʌ t ˈɛ v ɚ
wheel w ˈi l
whether w ˈɛ ð ɚ
whose h ˈu z
wide w ˈaɪ d
wife w ˈaɪ f
wild w ˈaɪ l d
win w ˈɪ n
window w ˈɪ n d oʊ
wine w ˈaɪ n
wing w ˈɪ ŋ
winter w ˈɪ n t ɚ
wish w ˈɪ ʃ
within w ɪ ð ˈɪ n
wonder w ˈʌ n d ɚ
wonderful w ˈʌ n d ɚ f ə l
wood w ˈʊ d
worker w ˈɚ k ɚ
worry w ˈɚ i
worth w ˈɚ θ
wrong ɹ ˈɔ ŋ
yard j ˈɑ ɹ d
yeah j ˈɛ ə
yellow j ˈɛ l oʊ
yesterday j ˈɛ s t ɚ d ˌeɪ
yourself j ɔ ɹ s ˈɛ l f
youth j ˈu θ
zone z ˈoʊ n
accepted æ k s ˈɛ p t ə d
added ˈæ d ə d
ability ə b ˈɪ l ə t i
absolutely ˌæ b s ə l ˈu t l i
according ə k ˈɔ ɹ d ɪ ŋ
achieve ə t͡ʃ ˈi v
activity æ k t ˈɪ v ə t i
adventure æ d v ˈɛ n t͡ʃ ɚ
africa ˈæ f ɹ ɪ k ə
agreed ə ɡ ɹ ˈi d
alive ə l ˈaɪ v
answered ˈæ n s ɚ d
appeared ə p ˈɪ ɹ d
army ˈɑ ɹ m i
arrived ə ɹ ˈaɪ v d
asked ˈæ s k t
asleep ə s l ˈi p
ate ˈeɪ t
aunt ˈæ n t
autumn ˈɔ t ə m
bathroom b ˈæ θ ɹ u m
bedroom b ˈɛ d ɹ u m
behave b ɪ h ˈeɪ v
believed b ɪ l ˈi v d
birthday b ˈɚ θ d eɪ
bitter b ˈɪ t ɚ
blame b l ˈeɪ m
blind b l ˈaɪ n d
blow b l ˈoʊ
boil b ˈɔɪ l
bought b ˈɔ t
brave b ɹ ˈeɪ v
broke b ɹ ˈoʊ k
broken b ɹ ˈoʊ k ə n
built b ˈɪ l t
cage k ˈeɪ d͡ʒ
called k ˈɔ l d
calm k ˈɑ m
carried k ˈɛ ɹ i d
caught k ˈɔ t
chapter t͡ʃ ˈæ p t ɚ
cheese t͡ʃ ˈi z
chest t͡ʃ ˈɛ s t
childhood t͡ʃ ˈaɪ l d h ʊ d
chocolate t͡ʃ ˈɔ k l ə t
chosen t͡ʃ ˈoʊ z ə n
cleaning k l ˈi n ɪ ŋ
clever k l ˈɛ v ɚ
climbed k l ˈaɪ m d
closer k l ˈoʊ s ɚ
coat k ˈoʊ t
comfortable k ˈʌ m f t ɚ b ə l
coming k ˈʌ m ɪ ŋ
completely k ə m p l ˈi t l i
confused k ə n f j ˈu z d
considered k ə n s ˈɪ d ɚ d
cousin k ˈʌ z ə n
covered k ˈʌ v ɚ d
crazy k ɹ ˈeɪ z i
cried k ɹ ˈaɪ d
curious k j ˈʊ ɹ i ə s
cute k j ˈu t
dangerous d ˈeɪ n d͡ʒ ɚ ə s
decided d ə s ˈaɪ d ə d
definitely d ˈɛ f ə n ə t l i
desert d ˈɛ z ɚ t
dessert d ɪ z ˈɚ t
died d ˈaɪ d
dirty d ˈɚ t i
doing d ˈu ɪ ŋ
drank d ɹ ˈæ ŋ k
drawn d ɹ ˈɔ n
dropped d ɹ ˈɑ p t
drove d ɹ ˈoʊ v
eaten ˈi t ə n
engineer ˌɛ n d͡ʒ ə n ˈɪ ɹ
enjoyed ɛ n d͡ʒ ˈɔɪ d
entered ˈɛ n t ɚ d
evil ˈi v ə l
excited ɪ k s ˈaɪ t ə d
exciting ɪ k s ˈaɪ t ɪ ŋ
expected ɪ k s p ˈɛ k t ə d
explained ɪ k s p l ˈeɪ n d
extremely ɪ k s t ɹ ˈi m l i
fallen f ˈɔ l ə n
fault f ˈɔ l t
favorite f ˈeɪ v ɚ ə t
fed f ˈɛ d
fellow f ˈɛ l oʊ
felt f ˈɛ l t
finished f ˈɪ n ɪ ʃ t
flew f l ˈu
followed f ˈɑ l oʊ d
foolish f ˈu l ɪ ʃ
forgot f ɚ ɡ ˈɑ t
forgotten f ɚ ɡ ˈɑ t ə n
fourth f ˈɔ ɹ θ
friendly f ɹ ˈɛ n d l i
frightened f ɹ ˈaɪ t ə n d
funny f ˈʌ n i
gate ɡ ˈeɪ t
gathered ɡ ˈæ ð ɚ d
gentleman d͡ʒ ˈɛ n t ə l m ə n
getting ɡ ˈɛ t ɪ ŋ
given ɡ ˈɪ v ə n
giving ɡ ˈɪ v ɪ ŋ
goes ɡ ˈoʊ z
golden ɡ ˈoʊ l d ə n
grandfather ɡ ɹ ˈæ n d f ˌɑ ð ɚ
grandmother ɡ ɹ ˈæ n d m ˌʌ ð ɚ
grateful ɡ ɹ ˈeɪ t f ə l
grown ɡ ɹ ˈoʊ n
happiness h ˈæ p i n ə s
having h ˈæ v ɪ ŋ
held h ˈɛ l d
helped h ˈɛ l p t
hers h ˈɚ z
hidden h ˈɪ d ə n
holding h ˈoʊ l d ɪ ŋ
honey h ˈʌ n i
hoping h ˈoʊ p ɪ ŋ
horrible h ˈɔ ɹ ə b ə l
hungry h ˈʌ ŋ ɡ ɹ i
hurried h ˈɚ i d
ill ˈɪ l
immediately ɪ m ˈi d i ə t l i
impossible ɪ m p ˈɑ s ə b ə l
jacket d͡ʒ ˈæ k ə t
joined d͡ʒ ˈɔɪ n d
kept k ˈɛ p t
killed k ˈɪ l d
kindness k ˈaɪ n d n ə s
kissed k ˈɪ s t
knowing n ˈoʊ ɪ ŋ
laughed l ˈæ f t
laughter l ˈæ f t ɚ
learned l ˈɚ n d
leaving l ˈi v ɪ ŋ
lied l ˈaɪ d
listened l ˈɪ s ə n d
living l ˈɪ v ɪ ŋ
looked l ˈʊ k t
looking l ˈʊ k ɪ ŋ
loved l ˈʌ v d
lovely l ˈʌ v l i
loving l ˈʌ v ɪ ŋ
lying l ˈaɪ ɪ ŋ
mad m ˈæ d
making m ˈeɪ k ɪ ŋ
married m ˈɛ ɹ i d
meant m ˈɛ n t
met m ˈɛ t
missed m ˈɪ s t
monkey m ˈʌ ŋ k i
moved m ˈu v d
moving m ˈu v ɪ ŋ
needed n ˈi d ə d
noticed n ˈoʊ t ə s t
nowhere n ˈoʊ w ɛ ɹ
offered ˈɔ f ɚ d
older ˈoʊ l d ɚ
opened ˈoʊ p ə n d
ordinary ˈɔ ɹ d ə n ˌɛ ɹ i
ours ˈaʊ ɚ z
owned ˈoʊ n d
passed p ˈæ s t
perfectly p ˈɚ f ɪ k t l i
picked p ˈɪ k t
played p l ˈeɪ d
playing p l ˈeɪ ɪ ŋ
pleased p l ˈi z d
pointed p ˈɔɪ n t ə d
prepared p ɹ ɪ p ˈɛ ɹ d
pulled p ˈʊ l d
pushed p ˈʊ ʃ t
putting p ˈʊ t ɪ ŋ
quietly k w ˈaɪ ə t l i
rabbit ɹ ˈæ b ə t
raised ɹ ˈeɪ z d
reached ɹ ˈi t͡ʃ t
reading ɹ ˈi d ɪ ŋ
realize ɹ ˈi ə l ˌaɪ z
realized ɹ ˈi ə l ˌaɪ z d
received ɹ ə s ˈi v d
remembered ɹ ɪ m ˈɛ m b ɚ d
replied ɹ ɪ p l ˈaɪ d
returned ɹ ɪ t ˈɚ n d
running ɹ ˈʌ n ɪ ŋ
sat s ˈæ t
saying s ˈeɪ ɪ ŋ
seemed s ˈi m d
seriously s ˈɪ ɹ i ə s l i
shouted ʃ ˈaʊ t ə d
showed ʃ ˈoʊ d
shut ʃ ˈʌ t
sight s ˈaɪ t
simply s ˈɪ m p l i
singing s ˈɪ ŋ ɪ ŋ
sitting s ˈɪ t ɪ ŋ
sleeping s l ˈi p ɪ ŋ
slept s l ˈɛ p t
slowly s l ˈoʊ l i
smiled s m ˈaɪ l d
sold s ˈoʊ l d
sometimes s ˈʌ m t aɪ m z
somewhat s ˈʌ m w ʌ t
sounded s ˈaʊ n d ə d
speaking s p ˈi k ɪ ŋ
spent s p ˈɛ n t
spoke s p ˈoʊ k
spoken s p ˈoʊ k ə n
standing s t ˈæ n d ɪ ŋ
stared s t ˈɛ ɹ d
started s t ˈɑ ɹ t ə d
stayed s t ˈeɪ d
stood s t ˈʊ d
stopped s t ˈɑ p t
stranger s t ɹ ˈeɪ n d͡ʒ ɚ
stupid s t ˈu p ə d
surprised s ɚ p ɹ ˈaɪ z d
taken t ˈeɪ k ə n
taking t ˈeɪ k ɪ ŋ
talked t ˈɔ k t
talking t ˈɔ k ɪ ŋ
taught t ˈɔ t
telling t ˈɛ l ɪ ŋ
terrible t ˈɛ ɹ ə b ə l
thinking θ ˈɪ ŋ k ɪ ŋ
thirsty θ ˈɚ s t i
threw θ ɹ ˈu
thrown θ ɹ ˈoʊ n
trying t ɹ ˈaɪ ɪ ŋ
turned t ˈɚ n d
turning t ˈɚ n ɪ ŋ
twice t w ˈaɪ s
ugly ˈʌ ɡ l i
understood ˌʌ n d ɚ s t ˈʊ d
upstairs ˌʌ p s t ˈɛ ɹ z
waited w ˈeɪ t ə d
waiting w ˈeɪ t ɪ ŋ
walked w ˈɔ k t
walking w ˈɔ k ɪ ŋ
watched w ˈɑ t͡ʃ t
watching w ˈɑ t͡ʃ ɪ ŋ
wearing w ˈɛ ɹ ɪ ŋ
whisper w ˈɪ s p ɚ
whispered w ˈɪ s p ɚ d
wished w ˈɪ ʃ t
woke w ˈoʊ k
woken w ˈoʊ k ə n
won w ˈʌ n
wooden w ˈʊ d ə n
wore w ˈɔ ɹ
working w ˈɚ k ɪ ŋ
worried w ˈɚ i d
worse w ˈɚ s
worst w ˈɚ s t
written ɹ ˈɪ t ə n
wrote ɹ ˈoʊ t
younger j ˈʌ ŋ ɡ ɚ
yours j ˈɔ ɹ z
abandon ə b ˈæ n d ə n
absence ˈæ b s ə n s
absent ˈæ b s ə n t
absolute ˈæ b s ə l ˌu t
absorb ə b z ˈɔ ɹ b
abstract ˈæ b s t ɹ æ k t
abuse ə b j ˈu s
academy ə k ˈæ d ə m i
accent ˈæ k s ɛ n t
accident ˈæ k s ə d ə n t
accompany ə k ˈʌ m p ə n i
accomplish ə k ˈɑ m p l ɪ ʃ
accurate ˈæ k j ɚ ə t
accuse ə k j ˈu z
ache ˈeɪ k
acid ˈæ s ə d
acknowledge ə k n ˈɑ l ɪ d͡ʒ
acquire ə k w ˈaɪ ɚ
acre ˈeɪ k ɚ
actor ˈæ k t ɚ
actress ˈæ k t ɹ ə s
adapt ə d ˈæ p t
addition ə d ˈɪ ʃ ə n
adequate ˈæ d ə k w ə t
adjust ə d͡ʒ ˈʌ s t
administration æ d m ˌɪ n ə s t ɹ ˈeɪ ʃ ə n
admire æ d m ˈaɪ ɚ
adopt ə d ˈɑ p t
advance æ d v ˈæ n s
advantage æ d v ˈæ n t ɪ d͡ʒ
advertise ˈæ d v ɚ t ˌaɪ z
advice æ d v ˈaɪ s
advise æ d v ˈaɪ z
affair ə f ˈɛ ɹ
afford ə f ˈɔ ɹ d
agreement ə ɡ ɹ ˈi m ə n t
agriculture ˈæ ɡ ɹ ə k ˌʌ l t͡ʃ ɚ
aid ˈeɪ d
aim ˈeɪ m
airplane ˈɛ ɹ p l ˌeɪ n
airport ˈɛ ɹ p ˌɔ ɹ t
alarm ə l ˈɑ ɹ m
album ˈæ l b ə m
alcohol ˈæ l k ə h ˌɔ l
alike ə l ˈaɪ k
alley ˈæ l i
aloud ə l ˈaʊ d
alphabet ˈæ l f ə b ˌɛ t
alter ˈɔ l t ɚ
aluminum ə l ˈu m ə n ə m
amaze ə m ˈeɪ z
ambition æ m b ˈɪ ʃ ə n
ambulance ˈæ m b j ə l ə n s
amuse ə m j ˈu z
analyze ˈæ n ə l ˌaɪ z
ankle ˈæ ŋ k ə l
anniversary ˌæ n ə v ˈɚ s ɚ i
annoy ə n ˈɔɪ
ant ˈæ n t
anxious ˈæ ŋ k ʃ ə s
apologize ə p ˈɑ l ə d͡ʒ ˌaɪ z
apology ə p ˈɑ l ə d͡ʒ i
apparent ə p ˈɛ ɹ ə n t
appeal ə p ˈi l
appearance ə p ˈɪ ɹ ə n s
appetite ˈæ p ə t ˌaɪ t
applaud ə p l ˈɔ d
appoint ə p ˈɔɪ n t
appointment ə p ˈɔɪ n t m ə n t
appreciate ə p ɹ ˈi ʃ i ˌeɪ t
appropriate ə p ɹ ˈoʊ p ɹ i ə t
approval ə p ɹ ˈu v ə l
approve ə p ɹ ˈu v
apron ˈeɪ p ɹ ə n
architect ˈɑ ɹ k ə t ˌɛ k t
arise ə ɹ ˈaɪ z
arithmetic ə ɹ ˈɪ θ m ə t ˌɪ k
arrange ə ɹ ˈeɪ n d͡ʒ
arrangement ə ɹ ˈeɪ n d͡ʒ m ə n t
arrest ə ɹ ˈɛ s t
arrival ə ɹ ˈaɪ v ə l
arrow ˈɛ ɹ oʊ
artificial ˌɑ ɹ t ə f ˈɪ ʃ ə l
ash ˈæ ʃ
ashamed ə ʃ ˈeɪ m d
aside ə s ˈaɪ d
aspect ˈæ s p ɛ k t
assign ə s ˈaɪ n
assignment ə s ˈaɪ n m ə n t
assist ə s ˈɪ s t
assistant ə s ˈɪ s t ə n t
assume ə s ˈu m
assure ə ʃ ˈʊ ɹ
astonish ə s t ˈɑ n ɪ ʃ
athlete ˈæ θ l i t
atmosphere ˈæ t m ə s f ˌɪ ɹ
atom ˈæ t ə m
attach ə t ˈæ t͡ʃ
attend ə t ˈɛ n d
attitude ˈæ t ə t ˌu d
attorney ə t ˈɚ n i
attract ə t ɹ ˈæ k t
attractive ə t ɹ ˈæ k t ɪ v
audience ˈɔ d i ə n s
authority ə θ ˈɔ ɹ ə t i
automatic ˌɔ t ə m ˈæ t ɪ k
automobile ˈɔ t ə m oʊ b ˌi l
avenue ˈæ v ə n ˌu
awake ə w ˈeɪ k
award ə w ˈɔ ɹ d
awful ˈɔ f ə l
awkward ˈɔ k w ɚ d
bacon b ˈeɪ k ə n
bacteria b æ k t ˈɪ ɹ i ə
badge b ˈæ d͡ʒ
bake b ˈeɪ k
balloon b ə l ˈu n
banana b ə n ˈæ n ə
bandage b ˈæ n d ɪ d͡ʒ
barber b ˈɑ ɹ b ɚ
bare b ˈɛ ɹ
barely b ˈɛ ɹ l i
bargain b ˈɑ ɹ ɡ ə n
bark b ˈɑ ɹ k
barn b ˈɑ ɹ n
barrel b ˈɛ ɹ ə l
baseball b ˈeɪ s b ˌɔ l
basement b ˈeɪ s m ə n t
basket b ˈæ s k ə t
basketball b ˈæ s k ə t b ˌɔ l
bat b ˈæ t
bath b ˈæ θ
bathe b ˈeɪ ð
battery b ˈæ t ɚ i
bay b ˈeɪ
bead b ˈi d
beam b ˈi m
bean b ˈi n
beard b ˈɪ ɹ d
beast b ˈi s t
beaver b ˈi v ɚ
bee b ˈi
beef b ˈi f
beer b ˈɪ ɹ
beetle b ˈi t ə l
beg b ˈɛ ɡ
belief b ɪ l ˈi f
belly b ˈɛ l i
belt b ˈɛ l t
bench b ˈɛ n t͡ʃ
bend b ˈɛ n d
berry b ˈɛ ɹ i
bet b ˈɛ t
bicycle b ˈaɪ s ɪ k ə l
bind b ˈaɪ n d
biology b aɪ ˈɑ l ə d͡ʒ i
birth b ˈɚ θ
biscuit b ˈɪ s k ə t
bite b ˈaɪ t
blade b l ˈeɪ d
blank b l ˈæ ŋ k
blanket b l ˈæ ŋ k ə t
blast b l ˈæ s t
blaze b l ˈeɪ z
bleed b l ˈi d
blend b l ˈɛ n d
bless b l ˈɛ s
blink b l ˈɪ ŋ k
bloom b l ˈu m
blossom b l ˈɑ s ə m
boast b ˈoʊ s t
bold b ˈoʊ l d
bomb b ˈɑ m
bond b ˈɑ n d
bonus b ˈoʊ n ə s
bore b ˈɔ ɹ
borrow b ˈɑ ɹ oʊ
boss b ˈɔ s
bounce b ˈaʊ n s
bound b ˈaʊ n d
boundary b ˈaʊ n d ɹ i
bowl b ˈoʊ l
brake b ɹ ˈeɪ k
brand b ɹ ˈæ n d
brass b ɹ ˈæ s
breast b ɹ ˈɛ s t
breed b ɹ ˈi d
breeze b ɹ ˈi z
brick b ɹ ˈɪ k
bride b ɹ ˈaɪ d
brilliant b ɹ ˈɪ l j ə n t
brim b ɹ ˈɪ m
broad b ɹ ˈɔ d
broadcast b ɹ ˈɔ d k ˌæ s t
bronze b ɹ ˈɑ n z
brook b ɹ ˈʊ k
broom b ɹ ˈu m
brush b ɹ ˈʌ ʃ
bubble b ˈʌ b ə l
bucket b ˈʌ k ə t
bud b ˈʌ d
bug b ˈʌ ɡ
bullet b ˈʊ l ə t
bump b ˈʌ m p
bunch b ˈʌ n t͡ʃ
bundle b ˈʌ n d ə l
burden b ˈɚ d ə n
burst b ˈɚ s t
bury b ˈɛ ɹ i
bus b ˈʌ s
bush b ˈʊ ʃ
butter b ˈʌ t ɚ
butterfly b ˈʌ t ɚ f l ˌaɪ
buyer b ˈaɪ ɚ
cab k ˈæ b
cabbage k ˈæ b ɪ d͡ʒ
cabin k ˈæ b ə n
cabinet k ˈæ b ə n ə t
cable k ˈeɪ b ə l
calendar k ˈæ l ə n d ɚ
calf k ˈæ f
camel k ˈæ m ə l
camp k ˈæ m p
campus k ˈæ m p ə s
canal k ə n ˈæ l
cancel k ˈæ n s ə l
candle k ˈæ n d ə l
candy k ˈæ n d i
cannon k ˈæ n ə n
canoe k ə n ˈu
canvas k ˈæ n v ə s
canyon k ˈæ n j ə n
cap k ˈæ p
capable k ˈeɪ p ə b ə l
capacity k ə p ˈæ s ə t i
cape k ˈeɪ p
capture k ˈæ p t͡ʃ ɚ
carbon k ˈɑ ɹ b ə n
cardboard k ˈɑ ɹ d b ˌɔ ɹ d
careless k ˈɛ ɹ l ə s
cargo k ˈɑ ɹ ɡ oʊ
carpenter k ˈɑ ɹ p ə n t ɚ
carpet k ˈɑ ɹ p ə t
carriage k ˈɛ ɹ ɪ d͡ʒ
carrot k ˈɛ ɹ ə t
cart k ˈɑ ɹ t
cartoon k ɑ ɹ t ˈu n
carve k ˈɑ ɹ v
cash k ˈæ ʃ
castle k ˈæ s ə l
casual k ˈæ ʒ u ə l
catalog k ˈæ t ə l ˌɔ ɡ
category k ˈæ t ə ɡ ˌɔ ɹ i
caterpillar k ˈæ t ɚ p ˌɪ l ɚ
cattle k ˈæ t ə l
caution k ˈɔ ʃ ə n
cave k ˈeɪ v
cease s ˈi s
ceiling s ˈi l ɪ ŋ
celebrate s ˈɛ l ə b ɹ ˌeɪ t
celebration s ˌɛ l ə b ɹ ˈeɪ ʃ ə n
cellar s ˈɛ l ɚ
cement s ə m ˈɛ n t
cemetery s ˈɛ m ə t ˌɛ ɹ i
cent s ˈɛ n t
certificate s ɚ t ˈɪ f ɪ k ə t
chain t͡ʃ ˈeɪ n
chairman t͡ʃ ˈɛ ɹ m ə n
chalk t͡ʃ ˈɔ k
chamber t͡ʃ ˈeɪ m b ɚ
channel t͡ʃ ˈæ n ə l
characteristic k ˌɛ ɹ ə k t ə ɹ ˈɪ s t ɪ k
charity t͡ʃ ˈɛ ɹ ə t i
charm t͡ʃ ˈɑ ɹ m
chase t͡ʃ ˈeɪ s
chat t͡ʃ ˈæ t
cheat t͡ʃ ˈi t
cheek t͡ʃ ˈi k
cheer t͡ʃ ˈɪ ɹ
chemical k ˈɛ m ɪ k ə l
chemistry k ˈɛ m ə s t ɹ i
cherry t͡ʃ ˈɛ ɹ i
chew t͡ʃ ˈu
chimney t͡ʃ ˈɪ m n i
chin t͡ʃ ˈɪ n
china t͡ʃ ˈaɪ n ə
chip t͡ʃ ˈɪ p
chop t͡ʃ ˈɑ p
christmas k ɹ ˈɪ s m ə s
circumstance s ˈɚ k ə m s t ˌæ n s
circus s ˈɚ k ə s
civil s ˈɪ v ə l
civilization s ˌɪ v ə l ə z ˈeɪ ʃ ə n
clap k l ˈæ p
classroom k l ˈæ s ɹ ˌu m
clay k l ˈeɪ
clerk k l ˈɚ k
client k l ˈaɪ ə n t
cliff k l ˈɪ f
climate k l ˈaɪ m ə t
clip k l ˈɪ p
cloth k l ˈɔ θ
clothing k l ˈoʊ ð ɪ ŋ
clown k l ˈaʊ n
clue k l ˈu
coal k ˈoʊ l
code k ˈoʊ d
coin k ˈɔɪ n
collar k ˈɑ l ɚ
colleague k ˈɑ l i ɡ
collection k ə l ˈɛ k ʃ ə n
colony k ˈɑ l ə n i
column k ˈɑ l ə m
comb k ˈoʊ m
combination k ˌɑ m b ə n ˈeɪ ʃ ə n
combine k ə m b ˈaɪ n
comedy k ˈɑ m ə d i
comfort k ˈʌ m f ɚ t
comma k ˈɑ m ə
commerce k ˈɑ m ɚ s
commercial k ə m ˈɚ ʃ ə l
commission k ə m ˈɪ ʃ ə n
commit k ə m ˈɪ t
committee k ə m ˈɪ t i
communicate k ə m j ˈu n ə k ˌeɪ t
communication k ə m j ˌu n ə k ˈeɪ ʃ ə n
companion k ə m p ˈæ n j ə n
comparison k ə m p ˈɛ ɹ ə s ə n
compete k ə m p ˈi t
competition k ˌɑ m p ə t ˈɪ ʃ ə n
complain k ə m p l ˈeɪ n
complaint k ə m p l ˈeɪ n t
complex k ə m p l ˈɛ k s
complicate k ˈɑ m p l ə k ˌeɪ t
compose k ə m p ˈoʊ z
composition k ˌɑ m p ə z ˈɪ ʃ ə n
compromise k ˈɑ m p ɹ ə m ˌaɪ z
conceal k ə n s ˈi l
concentrate k ˈɑ n s ə n t ɹ ˌeɪ t
concept k ˈɑ n s ɛ p t
concert k ˈɑ n s ɚ t
conclude k ə n k l ˈu d
conclusion k ə n k l ˈu ʒ ə n
concrete k ˈɑ n k ɹ i t
confess k ə n f ˈɛ s
confidence k ˈɑ n f ə d ə n s
confident k ˈɑ n f ə d ə n t
confirm k ə n f ˈɚ m
confuse k ə n f j ˈu z
confusion k ə n f j ˈu ʒ ə n
connection k ə n ˈɛ k ʃ ə n
conquer k ˈɑ ŋ k ɚ
conscience k ˈɑ n ʃ ə n s
conscious k ˈɑ n ʃ ə s
consequence k ˈɑ n s ə k w ˌɛ n s
considerable k ə n s ˈɪ d ɚ ə b ə l
consideration k ə n s ˌɪ d ə ɹ ˈeɪ ʃ ə n
consist k ə n s ˈɪ s t
constant k ˈɑ n s t ə n t
constitution k ˌɑ n s t ə t ˈu ʃ ə n
construct k ə n s t ɹ ˈʌ k t
construction k ə n s t ɹ ˈʌ k ʃ ə n
consult k ə n s ˈʌ l t
consume k ə n s ˈu m
consumer k ə n s ˈu m ɚ
contact k ˈɑ n t æ k t
container k ə n t ˈeɪ n ɚ
contemporary k ə n t ˈɛ m p ə ɹ ˌɛ ɹ i
continent k ˈɑ n t ə n ə n t
contribute k ə n t ɹ ˈɪ b j u t
contribution k ˌɑ n t ɹ ə b j ˈu ʃ ə n
convenient k ə n v ˈi n j ə n t
convince k ə n v ˈɪ n s
cookie k ˈʊ k i
copper k ˈɑ p ɚ
cord k ˈɔ ɹ d
core k ˈɔ ɹ
cork k ˈɔ ɹ k
corporation k ˌɔ ɹ p ə ɹ ˈeɪ ʃ ə n
costume k ˈɑ s t u m
cottage k ˈɑ t ɪ d͡ʒ
cough k ˈɔ f
council k ˈaʊ n s ə l
count k ˈaʊ n t
counter k ˈaʊ n t ɚ
county k ˈaʊ n t i
crack k ɹ ˈæ k
craft k ɹ ˈæ f t
crash k ɹ ˈæ ʃ
crawl k ɹ ˈɔ l
cream k ɹ ˈi m
creature k ɹ ˈi t͡ʃ ɚ
creek k ɹ ˈi k
creep k ɹ ˈi p
criminal k ɹ ˈɪ m ə n ə l
crisis k ɹ ˈaɪ s ə s
critic k ɹ ˈɪ t ɪ k
critical k ɹ ˈɪ t ɪ k ə l
criticism k ɹ ˈɪ t ə s ˌɪ z ə m
crop k ɹ ˈɑ p
crown k ɹ ˈaʊ n
cruel k ɹ ˈu ə l
crush k ɹ ˈʌ ʃ
crust k ɹ ˈʌ s t
crystal k ɹ ˈɪ s t ə l
cube k j ˈu b
cucumber k j ˈu k ʌ m b ɚ
cupboard k ˈʌ b ɚ d
cure k j ˈʊ ɹ
curl k ˈɚ l
curtain k ˈɚ t ə n
curve k ˈɚ v
cushion k ˈʊ ʃ ə n
dairy d ˈɛ ɹ i
daisy d ˈeɪ z i
dam d ˈæ m
damp d ˈæ m p
dare d ˈɛ ɹ
darkness d ˈɑ ɹ k n ə s
dash d ˈæ ʃ
database d ˈeɪ t ə b ˌeɪ s
gnome n ˈoʊ m
gnat n ˈæ t
gnaw n ˈɔ
diet d ˈaɪ ə t
dial d ˈaɪ ə l
quiet k w ˈaɪ ə t
poem p ˈoʊ ə m
poet p ˈoʊ ə t
geology d͡ʒ i ˈɑ l ə d͡ʒ i
photography f ə t ˈɑ ɡ ɹ ə f i
anatomy ə n ˈæ t ə m i
celebrity s ə l ˈɛ b ɹ ə t i
mysterious m ɪ s t ˈɪ ɹ i ə s
mystery m ˈɪ s t ɚ i
encyclopedia ɪ n s ˌaɪ k l ə p ˈi d i ə
association ə s ˌoʊ s i ˈeɪ ʃ ə n
dawn d ˈɔ n
deaf d ˈɛ f
dealer d ˈi l ɚ
debt d ˈɛ t
decade d ˈɛ k eɪ d
decay d ɪ k ˈeɪ
deceive d ɪ s ˈi v
declare d ɪ k l ˈɛ ɹ
decline d ɪ k l ˈaɪ n
decorate d ˈɛ k ə ɹ ˌeɪ t
deed d ˈi d
deer d ˈɪ ɹ
defeat d ɪ f ˈi t
defend d ɪ f ˈɛ n d
define d ɪ f ˈaɪ n
definition d ˌɛ f ə n ˈɪ ʃ ə n
delay d ɪ l ˈeɪ
deliberate d ɪ l ˈɪ b ɚ ə t
delicate d ˈɛ l ɪ k ə t
delight d ɪ l ˈaɪ t
deliver d ɪ l ˈɪ v ɚ
delivery d ɪ l ˈɪ v ɚ i
demonstrate d ˈɛ m ə n s t ɹ ˌeɪ t
dentist d ˈɛ n t ə s t
deny d ɪ n ˈaɪ
depart d ɪ p ˈɑ ɹ t
department d ɪ p ˈɑ ɹ t m ə n t
depend d ɪ p ˈɛ n d
deposit d ɪ p ˈɑ z ə t
depth d ˈɛ p θ
deputy d ˈɛ p j ə t i
derive d ə ɹ ˈaɪ v
descend d ɪ s ˈɛ n d
description d ɪ s k ɹ ˈɪ p ʃ ə n
deserve d ɪ z ˈɚ v
desire d ɪ z ˈaɪ ɚ
desperate d ˈɛ s p ɚ ə t
destination d ˌɛ s t ə n ˈeɪ ʃ ə n
destroy d ɪ s t ɹ ˈɔɪ
destruction d ɪ s t ɹ ˈʌ k ʃ ə n
detective d ɪ t ˈɛ k t ɪ v
development d ɪ v ˈɛ l ə p m ə n t
devil d ˈɛ v ə l
devote d ɪ v ˈoʊ t
diagram d ˈaɪ ə ɡ ɹ ˌæ m
dial d ˈaɪ ə l
diamond d ˈaɪ m ə n d
diary d ˈaɪ ɚ i
dig d ˈɪ ɡ
dim d ˈɪ m
dime d ˈaɪ m
dine d ˈaɪ n
dip d ˈɪ p
direct d ə ɹ ˈɛ k t
dirt d ˈɚ t
disagree d ˌɪ s ə ɡ ɹ ˈi
disappear d ˌɪ s ə p ˈɪ ɹ
disappoint d ˌɪ s ə p ˈɔɪ n t
disaster d ɪ z ˈæ s t ɚ
discipline d ˈɪ s ə p l ə n
discovery d ɪ s k ˈʌ v ɚ i
dish d ˈɪ ʃ
dismiss d ɪ s m ˈɪ s
display d ɪ s p l ˈeɪ
distant d ˈɪ s t ə n t
distinct d ɪ s t ˈɪ ŋ k t
distinguish d ɪ s t ˈɪ ŋ ɡ w ɪ ʃ
distribute d ɪ s t ɹ ˈɪ b j u t
district d ˈɪ s t ɹ ɪ k t
disturb d ɪ s t ˈɚ b
ditch d ˈɪ t͡ʃ
dive d ˈaɪ v
divide d ɪ v ˈaɪ d
division d ɪ v ˈɪ ʒ ə n
divorce d ɪ v ˈɔ ɹ s
dock d ˈɑ k
documentary d ˌɑ k j ə m ˈɛ n t ɚ i
dollars d ˈɑ l ɚ z
dolphin d ˈɑ l f ə n
domestic d ə m ˈɛ s t ɪ k
dominant d ˈɑ m ə n ə n t
donate d ˈoʊ n eɪ t
donkey d ˈɑ ŋ k i
dot d ˈɑ t
downstairs d ˌaʊ n s t ˈɛ ɹ z
downtown d ˌaʊ n t ˈaʊ n
drag d ɹ ˈæ ɡ
dragon d ɹ ˈæ ɡ ə n
drain d ɹ ˈeɪ n
drama d ɹ ˈɑ m ə
dramatic d ɹ ə m ˈæ t ɪ k
drawer d ɹ ˈɔ ɹ
drawing d ɹ ˈɔ ɪ ŋ
dreadful d ɹ ˈɛ d f ə l
drift d ɹ ˈɪ f t
drill d ɹ ˈɪ l
drip d ɹ ˈɪ p
driven d ɹ ˈɪ v ə n
drown d ɹ ˈaʊ n
drum d ɹ ˈʌ m
drunk d ɹ ˈʌ ŋ k
duck d ˈʌ k
dull d ˈʌ l
dumb d ˈʌ m
dump d ˈʌ m p
dungeon d ˈʌ n d͡ʒ ə n
dusty d ˈʌ s t i
dynamic d aɪ n ˈæ m ɪ k
eager ˈi ɡ ɚ
eagle ˈi ɡ ə l
ear ˈɪ ɹ
earn ˈɚ n
earthquake ˈɚ θ k w ˌeɪ k
ease ˈi z
east ˈi s t
economic ˌɛ k ə n ˈɑ m ɪ k
economics ˌɛ k ə n ˈɑ m ɪ k s
edit ˈɛ d ə t
edition ə d ˈɪ ʃ ə n
editor ˈɛ d ə t ɚ
educate ˈɛ d͡ʒ ə k ˌeɪ t
eel ˈi l
effective ə f ˈɛ k t ɪ v
efficient ə f ˈɪ ʃ ə n t
eighth ˈeɪ t θ
elbow ˈɛ l b oʊ
elder ˈɛ l d ɚ
elect ə l ˈɛ k t
electricity ə l ˌɛ k t ɹ ˈɪ s ə t i
electronic ə l ˌɛ k t ɹ ˈɑ n ɪ k
elegant ˈɛ l ə ɡ ə n t
element ˈɛ l ə m ə n t
elementary ˌɛ l ə m ˈɛ n t ɹ i
elephant ˈɛ l ə f ə n t
elevator ˈɛ l ə v ˌeɪ t ɚ
eliminate ə l ˈɪ m ə n ˌeɪ t
elsewhere ˈɛ l s w ˌɛ ɹ
embarrass ɪ m b ˈɛ ɹ ə s
emerge ə m ˈɚ d͡ʒ
emotional ə m ˈoʊ ʃ ə n ə l
emperor ˈɛ m p ɚ ɚ
emphasis ˈɛ m f ə s ə s
emphasize ˈɛ m f ə s ˌaɪ z
empire ˈɛ m p aɪ ɚ
employ ɪ m p l ˈɔɪ
employer ɪ m p l ˈɔɪ ɚ
employment ɪ m p l ˈɔɪ m ə n t
enable ɪ n ˈeɪ b ə l
encounter ɪ n k ˈaʊ n t ɚ
encourage ɪ n k ˈɚ ɪ d͡ʒ
enemy ˈɛ n ə m i
engage ɪ n ɡ ˈeɪ d͡ʒ
enormous ə n ˈɔ ɹ m ə s
ensure ɪ n ʃ ˈʊ ɹ
enthusiasm ɪ n θ ˈu z i ˌæ z ə m
entertain ˌɛ n t ɚ t ˈeɪ n
entrance ˈɛ n t ɹ ə n s
entry ˈɛ n t ɹ i
envelope ˈɛ n v ə l ˌoʊ p
envy ˈɛ n v i
episode ˈɛ p ə s ˌoʊ d
equally ˈi k w ə l i
equation ɪ k w ˈeɪ ʒ ə n
era ˈɛ ɹ ə
erase ə ɹ ˈeɪ s
essay ˈɛ s eɪ
essential ə s ˈɛ n ʃ ə l
estate ə s t ˈeɪ t
evaluate ɪ v ˈæ l j u ˌeɪ t
eventually ɪ v ˈɛ n t͡ʃ u ə l i
everyday ˈɛ v ɹ i d ˌeɪ
exam ɪ ɡ z ˈæ m
examination ɪ ɡ z ˌæ m ə n ˈeɪ ʃ ə n
exceed ɪ k s ˈi d
excellence ˈɛ k s ə l ə n s
exception ɪ k s ˈɛ p ʃ ə n
excess ˈɛ k s ɛ s
exhaust ɪ ɡ z ˈɔ s t
exhibit ɪ ɡ z ˈɪ b ə t
exit ˈɛ ɡ z ə t
expand ɪ k s p ˈæ n d
expansion ɪ k s p ˈæ n ʃ ə n
expense ɪ k s p ˈɛ n s
explanation ˌɛ k s p l ə n ˈeɪ ʃ ə n
explode ɪ k s p l ˈoʊ d
explore ɪ k s p l ˈɔ ɹ
explosion ɪ k s p l ˈoʊ ʒ ə n
expose ɪ k s p ˈoʊ z
expression ɪ k s p ɹ ˈɛ ʃ ə n
extend ɪ k s t ˈɛ n d
extension ɪ k s t ˈɛ n ʃ ə n
extent ɪ k s t ˈɛ n t
external ɪ k s t ˈɚ n ə l
extraordinary ɪ k s t ɹ ˈɔ ɹ d ə n ˌɛ ɹ i
extreme ɪ k s t ɹ ˈi m
fabric f ˈæ b ɹ ɪ k
fade f ˈeɪ d
failure f ˈeɪ l j ɚ
faint f ˈeɪ n t
fairy f ˈɛ ɹ i
fake f ˈeɪ k
fame f ˈeɪ m
fancy f ˈæ n s i
fantastic f æ n t ˈæ s t ɪ k
fantasy f ˈæ n t ə s i
fare f ˈɛ ɹ
farewell f ˌɛ ɹ w ˈɛ l
fasten f ˈæ s ə n
fatal f ˈeɪ t ə l
fate f ˈeɪ t
faucet f ˈɔ s ə t
favor f ˈeɪ v ɚ
feast f ˈi s t
feather f ˈɛ ð ɚ
fee f ˈi
feeble f ˈi b ə l
female f ˈi m eɪ l
fence f ˈɛ n s
fever f ˈi v ɚ
fiber f ˈaɪ b ɚ
fiction f ˈɪ k ʃ ə n
fierce f ˈɪ ɹ s
fifth f ˈɪ f θ
fig f ˈɪ ɡ
financial f ə n ˈæ n ʃ ə l
firefighter f ˈaɪ ɚ f ˌaɪ t ɚ
fireplace f ˈaɪ ɚ p l ˌeɪ s
firmly f ˈɚ m l i
fisherman f ˈɪ ʃ ɚ m ə n
fist f ˈɪ s t
fitness f ˈɪ t n ə s
flag f l ˈæ ɡ
flame f l ˈeɪ m
flash f l ˈæ ʃ
flavor f l ˈeɪ v ɚ
flee f l ˈi
fleet f l ˈi t
flesh f l ˈɛ ʃ
flexible f l ˈɛ k s ə b ə l
float f l ˈoʊ t
flock f l ˈɑ k
flood f l ˈʌ d
flour f l ˈaʊ ɚ
fluid f l ˈu ə d
flush f l ˈʌ ʃ
foam f ˈoʊ m
fog f ˈɔ ɡ
fold f ˈoʊ l d
folk f ˈoʊ k
fond f ˈɑ n d
fool f ˈu l
football f ˈʊ t b ˌɔ l
forbid f ɚ b ˈɪ d
force f ˈɔ ɹ s
forecast f ˈɔ ɹ k ˌæ s t
forehead f ˈɔ ɹ h ˌɛ d
foreign f ˈɔ ɹ ə n
foreigner f ˈɔ ɹ ə n ɚ
forgive f ɚ ɡ ˈɪ v
fork f ˈɔ ɹ k
formal f ˈɔ ɹ m ə l
format f ˈɔ ɹ m æ t
formation f ɔ ɹ m ˈeɪ ʃ ə n
former f ˈɔ ɹ m ɚ
formula f ˈɔ ɹ m j ə l ə
fort f ˈɔ ɹ t
fortunate f ˈɔ ɹ t͡ʃ ə n ə t
fortune f ˈɔ ɹ t͡ʃ ə n
forum f ˈɔ ɹ ə m
fossil f ˈɑ s ə l
foundation f aʊ n d ˈeɪ ʃ ə n
fountain f ˈaʊ n t ə n
fox f ˈɑ k s
fraction f ɹ ˈæ k ʃ ə n
fragile f ɹ ˈæ d͡ʒ ə l
freedom f ɹ ˈi d ə m
freeze f ɹ ˈi z
freight f ɹ ˈeɪ t
frequency f ɹ ˈi k w ə n s i
frequent f ɹ ˈi k w ə n t
friendship f ɹ ˈɛ n d ʃ ˌɪ p
frog f ɹ ˈɔ ɡ
frost f ɹ ˈɔ s t
frown f ɹ ˈaʊ n
froze f ɹ ˈoʊ z
frozen f ɹ ˈoʊ z ə n
fry f ɹ ˈaɪ
fuel f j ˈu ə l
fundamental f ˌʌ n d ə m ˈɛ n t ə l
funeral f j ˈu n ɚ ə l
fur f ˈɚ
furious f j ˈʊ ɹ i ə s
furnace f ˈɚ n ə s
furniture f ˈɚ n ɪ t͡ʃ ɚ
further f ˈɚ ð ɚ
furthermore f ˈɚ ð ɚ m ˌɔ ɹ
fury f j ˈʊ ɹ i
gain ɡ ˈeɪ n
galaxy ɡ ˈæ l ə k s i
gallery ɡ ˈæ l ɚ i
gallon ɡ ˈæ l ə n
gamble ɡ ˈæ m b ə l
gap ɡ ˈæ p
garage ɡ ə ɹ ˈɑ ʒ
garbage ɡ ˈɑ ɹ b ɪ d͡ʒ
garlic ɡ ˈɑ ɹ l ɪ k
gasoline ɡ ˈæ s ə l ˌi n
gaze ɡ ˈeɪ z
gear ɡ ˈɪ ɹ
gene d͡ʒ ˈi n
generate d͡ʒ ˈɛ n ə ɹ ˌeɪ t
generous d͡ʒ ˈɛ n ɚ ə s
genius d͡ʒ ˈi n j ə s
genuine d͡ʒ ˈɛ n j u ə n
geography d͡ʒ i ˈɑ ɡ ɹ ə f i
gesture d͡ʒ ˈɛ s t͡ʃ ɚ
ghost ɡ ˈoʊ s t
giant d͡ʒ ˈaɪ ə n t
giggle ɡ ˈɪ ɡ ə l
ginger d͡ʒ ˈɪ n d͡ʒ ɚ
giraffe d͡ʒ ə ɹ ˈæ f
glance ɡ l ˈæ n s
globe ɡ l ˈoʊ b
glory ɡ l ˈɔ ɹ i
glove ɡ l ˈʌ v
glow ɡ l ˈoʊ
glue ɡ l ˈu
goat ɡ ˈoʊ t
goodbye ɡ ʊ d b ˈaɪ
goods ɡ ˈʊ d z
goose ɡ ˈu s
gossip ɡ ˈɑ s ə p
govern ɡ ˈʌ v ɚ n
governor ɡ ˈʌ v ɚ n ɚ
grab ɡ ɹ ˈæ b
grace ɡ ɹ ˈeɪ s
grade ɡ ɹ ˈeɪ d
gradual ɡ ɹ ˈæ d͡ʒ u ə l
grain ɡ ɹ ˈeɪ n
grammar ɡ ɹ ˈæ m ɚ
grant ɡ ɹ ˈæ n t
grape ɡ ɹ ˈeɪ p
graph ɡ ɹ ˈæ f
grasp ɡ ɹ ˈæ s p
grave ɡ ɹ ˈeɪ v
gravity ɡ ɹ ˈæ v ə t i
grease ɡ ɹ ˈi s
greet ɡ ɹ ˈi t
grief ɡ ɹ ˈi f
grin ɡ ɹ ˈɪ n
grind ɡ ɹ ˈaɪ n d
grip ɡ ɹ ˈɪ p
grocery ɡ ɹ ˈoʊ s ɚ i
groom ɡ ɹ ˈu m
groan ɡ ɹ ˈoʊ n
guarantee ɡ ˌɛ ɹ ə n t ˈi
guilt ɡ ˈɪ l t
guilty ɡ ˈɪ l t i
guitar ɡ ɪ t ˈɑ ɹ
gulf ɡ ˈʌ l f
gum ɡ ˈʌ m
gym d͡ʒ ˈɪ m
habit h ˈæ b ə t
hail h ˈeɪ l
hallway h ˈɔ l w ˌeɪ
halt h ˈɔ l t
hammer h ˈæ m ɚ
handsome h ˈæ n s ə m
harbor h ˈɑ ɹ b ɚ
hardware h ˈɑ ɹ d w ˌɛ ɹ
harsh h ˈɑ ɹ ʃ
harvest h ˈɑ ɹ v ə s t
haste h ˈeɪ s t
hat h ˈæ t
hatch h ˈæ t͡ʃ
hawk h ˈɔ k
hay h ˈeɪ
hazard h ˈæ z ɚ d
headache h ˈɛ d ˌeɪ k
headline h ˈɛ d l ˌaɪ n
headquarters h ˈɛ d k w ˌɔ ɹ t ɚ z
heal h ˈi l
heap h ˈi p
heaven h ˈɛ v ə n
heavily h ˈɛ v ə l i
heel h ˈi l
height h ˈaɪ t
helicopter h ˈɛ l ə k ˌɑ p t ɚ
hell h ˈɛ l
helmet h ˈɛ l m ə t
helpful h ˈɛ l p f ə l
hen h ˈɛ n
herd h ˈɚ d
heritage h ˈɛ ɹ ə t ɪ d͡ʒ
hero h ˈɪ ɹ oʊ
hesitate h ˈɛ z ə t ˌeɪ t
hint h ˈɪ n t
hip h ˈɪ p
hire h ˈaɪ ɚ
historian h ɪ s t ˈɔ ɹ i ə n
historic h ɪ s t ˈɔ ɹ ɪ k
historical h ɪ s t ˈɔ ɹ ɪ k ə l
hobby h ˈɑ b i
hockey h ˈɑ k i
hollow h ˈɑ l oʊ
holy h ˈoʊ l i
homework h ˈoʊ m w ˌɚ k
honor ˈɑ n ɚ
hook h ˈʊ k
hop h ˈɑ p
horizon h ə ɹ ˈaɪ z ə n
horn h ˈɔ ɹ n
horror h ˈɔ ɹ ɚ
household h ˈaʊ s h ˌoʊ l d
housing h ˈaʊ z ɪ ŋ
hug h ˈʌ ɡ
hum h ˈʌ m
humble h ˈʌ m b ə l
humor h j ˈu m ɚ
hunger h ˈʌ ŋ ɡ ɚ
hunt h ˈʌ n t
hunter h ˈʌ n t ɚ
hurricane h ˈɚ ə k ˌeɪ n
hurry h ˈɚ i
hut h ˈʌ t
hydrogen h ˈaɪ d ɹ ə d͡ʒ ə n
icon ˈaɪ k ɑ n
ideal aɪ d ˈi ə l
identify aɪ d ˈɛ n t ə f ˌaɪ
identity aɪ d ˈɛ n t ə t i
idle ˈaɪ d ə l
ignore ɪ ɡ n ˈɔ ɹ
illegal ɪ l ˈi ɡ ə l
illness ˈɪ l n ə s
illustrate ˈɪ l ə s t ɹ ˌeɪ t
imagination ɪ m ˌæ d͡ʒ ə n ˈeɪ ʃ ə n
imitate ˈɪ m ə t ˌeɪ t
immediate ɪ m ˈi d i ə t
immense ɪ m ˈɛ n s
immigrant ˈɪ m ə ɡ ɹ ə n t
implement ˈɪ m p l ə m ə n t
imply ɪ m p l ˈaɪ
importance ɪ m p ˈɔ ɹ t ə n s
impose ɪ m p ˈoʊ z
impress ɪ m p ɹ ˈɛ s
impression ɪ m p ɹ ˈɛ ʃ ə n
improvement ɪ m p ɹ ˈu v m ə n t
incident ˈɪ n s ə d ə n t
include ɪ n k l ˈu d
income ˈɪ n k ʌ m
incredible ɪ n k ɹ ˈɛ d ə b ə l
independence ˌɪ n d ə p ˈɛ n d ə n s
independent ˌɪ n d ə p ˈɛ n d ə n t
index ˈɪ n d ɛ k s
indicate ˈɪ n d ə k ˌeɪ t
individual ˌɪ n d ə v ˈɪ d͡ʒ u ə l
industrial ɪ n d ˈʌ s t ɹ i ə l
infant ˈɪ n f ə n t
infection ɪ n f ˈɛ k ʃ ə n
inflation ɪ n f l ˈeɪ ʃ ə n
influence ˈɪ n f l u ə n s
inform ɪ n f ˈɔ ɹ m
ingredient ɪ n ɡ ɹ ˈi d i ə n t
initial ə n ˈɪ ʃ ə l
injure ˈɪ n d͡ʒ ɚ
injury ˈɪ n d͡ʒ ɚ i
ink ˈɪ ŋ k
inner ˈɪ n ɚ
innocent ˈɪ n ə s ə n t
input ˈɪ n p ˌʊ t
inquire ɪ n k w ˈaɪ ɚ
insect ˈɪ n s ɛ k t
insist ɪ n s ˈɪ s t
inspect ɪ n s p ˈɛ k t
inspire ɪ n s p ˈaɪ ɚ
install ɪ n s t ˈɔ l
instant ˈɪ n s t ə n t
instinct ˈɪ n s t ɪ ŋ k t
institute ˈɪ n s t ə t ˌu t
instruction ɪ n s t ɹ ˈʌ k ʃ ə n
instrument ˈɪ n s t ɹ ə m ə n t
insurance ɪ n ʃ ˈʊ ɹ ə n s
intelligence ɪ n t ˈɛ l ə d͡ʒ ə n s
intelligent ɪ n t ˈɛ l ə d͡ʒ ə n t
intend ɪ n t ˈɛ n d
intense ɪ n t ˈɛ n s
intention ɪ n t ˈɛ n ʃ ə n
internal ɪ n t ˈɚ n ə l
interpret ɪ n t ˈɚ p ɹ ə t
interrupt ˌɪ n t ə ɹ ˈʌ p t
introduction ˌɪ n t ɹ ə d ˈʌ k ʃ ə n
invent ɪ n v ˈɛ n t
invention ɪ n v ˈɛ n ʃ ə n
invest ɪ n v ˈɛ s t
investigate ɪ n v ˈɛ s t ə ɡ ˌeɪ t
invitation ˌɪ n v ə t ˈeɪ ʃ ə n
invite ɪ n v ˈaɪ t
ivory ˈaɪ v ɹ i
jail d͡ʒ ˈeɪ l
jam d͡ʒ ˈæ m
jar d͡ʒ ˈɑ ɹ
jaw d͡ʒ ˈɔ
jazz d͡ʒ ˈæ z
jealous d͡ʒ ˈɛ l ə s
jeans d͡ʒ ˈi n z
jelly d͡ʒ ˈɛ l i
jewel d͡ʒ ˈu ə l
jewelry d͡ʒ ˈu ə l ɹ i
joint d͡ʒ ˈɔɪ n t
journal d͡ʒ ˈɚ n ə l
journalist d͡ʒ ˈɚ n ə l ə s t
judgment d͡ʒ ˈʌ d͡ʒ m ə n t
juice d͡ʒ ˈu s
junction d͡ʒ ˈʌ ŋ k ʃ ə n
jungle d͡ʒ ˈʌ ŋ ɡ ə l
junior d͡ʒ ˈu n j ɚ
junk d͡ʒ ˈʌ ŋ k
jury d͡ʒ ˈʊ ɹ i
justice d͡ʒ ˈʌ s t ə s
justify d͡ʒ ˈʌ s t ə f ˌaɪ
kangaroo k ˌæ ŋ ɡ ə ɹ ˈu
keen k ˈi n
kettle k ˈɛ t ə l
keyboard k ˈi b ˌɔ ɹ d
kidney k ˈɪ d n i
kingdom k ˈɪ ŋ d ə m
kiss k ˈɪ s
kit k ˈɪ t
kite k ˈaɪ t
kitten k ˈɪ t ə n
kneel n ˈi l
knit n ˈɪ t
knob n ˈɑ b
knot n ˈɑ t
lab l ˈæ b
label l ˈeɪ b ə l
labor l ˈeɪ b ɚ
laboratory l ˈæ b ɹ ə t ˌɔ ɹ i
lace l ˈeɪ s
ladder l ˈæ d ɚ
lamb l ˈæ m
lamp l ˈæ m p
landlord l ˈæ n d l ˌɔ ɹ d
landscape l ˈæ n d s k ˌeɪ p
lane l ˈeɪ n
lantern l ˈæ n t ɚ n
lap l ˈæ p
laptop l ˈæ p t ˌɑ p
laundry l ˈɔ n d ɹ i
lawn l ˈɔ n
layer l ˈeɪ ɚ
lazy l ˈeɪ z i
leaf l ˈi f
league l ˈi ɡ
leak l ˈi k
lean l ˈi n
leap l ˈi p
leather l ˈɛ ð ɚ
lecture l ˈɛ k t͡ʃ ɚ
legend l ˈɛ d͡ʒ ə n d
leisure l ˈi ʒ ɚ
lemon l ˈɛ m ə n
lend l ˈɛ n d
length l ˈɛ ŋ k θ
lens l ˈɛ n z
leopard l ˈɛ p ɚ d
lettuce l ˈɛ t ə s
liberal l ˈɪ b ɚ ə l
liberty l ˈɪ b ɚ t i
license l ˈaɪ s ə n s
lid l ˈɪ d
lift l ˈɪ f t
lightning l ˈaɪ t n ɪ ŋ
limb l ˈɪ m
lime l ˈaɪ m
linen l ˈɪ n ə n
lion l ˈaɪ ə n
liquid l ˈɪ k w ə d
literary l ˈɪ t ə ɹ ˌɛ ɹ i
literature l ˈɪ t ɚ ə t͡ʃ ɚ
litter l ˈɪ t ɚ
liver l ˈɪ v ɚ
lizard l ˈɪ z ɚ d
load l ˈoʊ d
loaf l ˈoʊ f
loan l ˈoʊ n
lobby l ˈɑ b i
lobster l ˈɑ b s t ɚ
locate l ˈoʊ k eɪ t
location l oʊ k ˈeɪ ʃ ə n
log l ˈɔ ɡ
logic l ˈɑ d͡ʒ ɪ k
logical l ˈɑ d͡ʒ ɪ k ə l
loose l ˈu s
lord l ˈɔ ɹ d
lorry l ˈɔ ɹ i
lot l ˈɑ t
lotion l ˈoʊ ʃ ə n
loyal l ˈɔɪ ə l
luck l ˈʌ k
luggage l ˈʌ ɡ ɪ d͡ʒ
lumber l ˈʌ m b ɚ
lump l ˈʌ m p
lung l ˈʌ ŋ
luxury l ˈʌ k ʃ ɚ i
machinery m ə ʃ ˈi n ɚ i
magazine m ˈæ ɡ ə z ˌi n
magic m ˈæ d͡ʒ ɪ k
magnet m ˈæ ɡ n ə t
magnificent m æ ɡ n ˈɪ f ə s ə n t
maid m ˈeɪ d
male m ˈeɪ l
mall m ˈɔ l
mammal m ˈæ m ə l
management m ˈæ n ɪ d͡ʒ m ə n t
mankind m ˌæ n k ˈaɪ n d
manner m ˈæ n ɚ
mansion m ˈæ n ʃ ə n
manual m ˈæ n j u ə l
manufacture m ˌæ n j ə f ˈæ k t͡ʃ ɚ
map m ˈæ p
marble m ˈɑ ɹ b ə l
margin m ˈɑ ɹ d͡ʒ ə n
marine m ə ɹ ˈi n
marker m ˈɑ ɹ k ɚ
marvelous m ˈɑ ɹ v ə l ə s
mask m ˈæ s k
massive m ˈæ s ɪ v
mat m ˈæ t
mate m ˈeɪ t
mathematics m ˌæ θ ə m ˈæ t ɪ k s
mature m ə t͡ʃ ˈʊ ɹ
maximum m ˈæ k s ə m ə m
mayor m ˈeɪ ɚ
meadow m ˈɛ d oʊ
meaning m ˈi n ɪ ŋ
means m ˈi n z
meanwhile m ˈi n w ˌaɪ l
mechanic m ə k ˈæ n ɪ k
mechanical m ə k ˈæ n ɪ k ə l
mechanism m ˈɛ k ə n ˌɪ z ə m
medal m ˈɛ d ə l
medium m ˈi d i ə m
melody m ˈɛ l ə d i
melt m ˈɛ l t
membership m ˈɛ m b ɚ ʃ ˌɪ p
memorial m ə m ˈɔ ɹ i ə l
mental m ˈɛ n t ə l
menu m ˈɛ n j u
merchant m ˈɚ t͡ʃ ə n t
mercy m ˈɚ s i
mere m ˈɪ ɹ
merry m ˈɛ ɹ i
mess m ˈɛ s
meter m ˈi t ɚ
microphone m ˈaɪ k ɹ ə f ˌoʊ n
microscope m ˈaɪ k ɹ ə s k ˌoʊ p
microwave m ˈaɪ k ɹ ə w ˌeɪ v
mild m ˈaɪ l d
mill m ˈɪ l
mineral m ˈɪ n ɚ ə l
minimum m ˈɪ n ə m ə m
minority m ə n ˈɔ ɹ ə t i
miracle m ˈɪ ɹ ə k ə l
mischief m ˈɪ s t͡ʃ ə f
miserable m ˈɪ z ɚ ə b ə l
misery m ˈɪ z ɚ i
mixture m ˈɪ k s t͡ʃ ɚ
mobile m ˈoʊ b ə l
modest m ˈɑ d ə s t
moisture m ˈɔɪ s t͡ʃ ɚ
mole m ˈoʊ l
monitor m ˈɑ n ə t ɚ
monk m ˈʌ ŋ k
monster m ˈɑ n s t ɚ
monthly m ˈʌ n θ l i
monument m ˈɑ n j ə m ə n t
mood m ˈu d
moral m ˈɔ ɹ ə l
moreover m ɔ ɹ ˈoʊ v ɚ
mosquito m ə s k ˈi t oʊ
moss m ˈɔ s
motion m ˈoʊ ʃ ə n
motivate m ˈoʊ t ə v ˌeɪ t
motor m ˈoʊ t ɚ
motorcycle m ˈoʊ t ɚ s ˌaɪ k ə l
mouse m ˈaʊ s
moustache m ˈʌ s t æ ʃ
mud m ˈʌ d
mule m j ˈu l
multiple m ˈʌ l t ə p ə l
multiply m ˈʌ l t ə p l ˌaɪ
murder m ˈɚ d ɚ
muscle m ˈʌ s ə l
museum m j u z ˈi ə m
mushroom m ˈʌ ʃ ɹ ˌu m
musical m j ˈu z ɪ k ə l
musician m j u z ˈɪ ʃ ə n
mystery m ˈɪ s t ɚ i
nail n ˈeɪ l
naked n ˈeɪ k ə d
nap n ˈæ p
napkin n ˈæ p k ə n
narrative n ˈɛ ɹ ə t ɪ v
nasty n ˈæ s t i
native n ˈeɪ t ɪ v
naval n ˈeɪ v ə l
navy n ˈeɪ v i
nearby n ˌɪ ɹ b ˈaɪ
neat n ˈi t
needle n ˈi d ə l
negative n ˈɛ ɡ ə t ɪ v
neglect n ɪ ɡ l ˈɛ k t
negotiate n ə ɡ ˈoʊ ʃ i ˌeɪ t
neighborhood n ˈeɪ b ɚ h ˌʊ d
nephew n ˈɛ f j u
nerve n ˈɚ v
nest n ˈɛ s t
net n ˈɛ t
neutral n ˈu t ɹ ə l
nevertheless n ˌɛ v ɚ ð ə l ˈɛ s
nickel n ˈɪ k ə l
niece n ˈi s
nightmare n ˈaɪ t m ˌɛ ɹ
ninth n ˈaɪ n θ
nitrogen n ˈaɪ t ɹ ə d͡ʒ ə n
noble n ˈoʊ b ə l
nod n ˈɑ d
noisy n ˈɔɪ z i
nonsense n ˈɑ n s ɛ n s
northern n ˈɔ ɹ ð ɚ n
notebook n ˈoʊ t b ˌʊ k
notion n ˈoʊ ʃ ə n
novel n ˈɑ v ə l
nuclear n ˈu k l i ɚ
numerous n ˈu m ɚ ə s
nut n ˈʌ t
nutrition n u t ɹ ˈɪ ʃ ə n
oak ˈoʊ k
oar ˈɔ ɹ
oath ˈoʊ θ
obey oʊ b ˈeɪ
objection ə b d͡ʒ ˈɛ k ʃ ə n
obligation ˌɑ b l ə ɡ ˈeɪ ʃ ə n
observation ˌɑ b z ɚ v ˈeɪ ʃ ə n
observe ə b z ˈɚ v
obstacle ˈɑ b s t ə k ə l
obtain ə b t ˈeɪ n
obvious ˈɑ b v i ə s
occasion ə k ˈeɪ ʒ ə n
occasional ə k ˈeɪ ʒ ə n ə l
occupation ˌɑ k j ə p ˈeɪ ʃ ə n
occupy ˈɑ k j ə p ˌaɪ
odd ˈɑ d
odor ˈoʊ d ɚ
offend ə f ˈɛ n d
offense ə f ˈɛ n s
olive ˈɑ l ɪ v
onion ˈʌ n j ə n
onto ˈɑ n t u
operate ˈɑ p ə ɹ ˌeɪ t
operator ˈɑ p ə ɹ ˌeɪ t ɚ
opponent ə p ˈoʊ n ə n t
oppose ə p ˈoʊ z
opposite ˈɑ p ə z ə t
oral ˈɔ ɹ ə l
orbit ˈɔ ɹ b ə t
orchestra ˈɔ ɹ k ə s t ɹ ə
organ ˈɔ ɹ ɡ ə n
organic ɔ ɹ ɡ ˈæ n ɪ k
organize ˈɔ ɹ ɡ ə n ˌaɪ z
origin ˈɔ ɹ ə d͡ʒ ə n
orphan ˈɔ ɹ f ə n
ounce ˈaʊ n s
outcome ˈaʊ t k ˌʌ m
outdoor ˈaʊ t d ˌɔ ɹ
outer ˈaʊ t ɚ
outfit ˈaʊ t f ˌɪ t
outline ˈaʊ t l ˌaɪ n
output ˈaʊ t p ˌʊ t
outstanding aʊ t s t ˈæ n d ɪ ŋ
oven ˈʌ v ə n
overcome ˌoʊ v ɚ k ˈʌ m
overlook ˌoʊ v ɚ l ˈʊ k
overnight ˌoʊ v ɚ n ˈaɪ t
overseas ˌoʊ v ɚ s ˈi z
owe ˈoʊ
owl ˈaʊ l
oxygen ˈɑ k s ə d͡ʒ ə n
oyster ˈɔɪ s t ɚ
pace p ˈeɪ s
pack p ˈæ k
package p ˈæ k ɪ d͡ʒ
pad p ˈæ d
paddle p ˈæ d ə l
painful p ˈeɪ n f ə l
painter p ˈeɪ n t ɚ
painting p ˈeɪ n t ɪ ŋ
pajamas p ə d͡ʒ ˈɑ m ə z
palace p ˈæ l ə s
pale p ˈeɪ l
palm p ˈɑ m
pan p ˈæ n
pancake p ˈæ n k ˌeɪ k
panel p ˈæ n ə l
panic p ˈæ n ɪ k
pant p ˈæ n t
parade p ə ɹ ˈeɪ d
paradise p ˈɛ ɹ ə d ˌaɪ s
paragraph p ˈɛ ɹ ə ɡ ɹ ˌæ f
parallel p ˈɛ ɹ ə l ˌɛ l
parcel p ˈɑ ɹ s ə l
pardon p ˈɑ ɹ d ə n
parliament p ˈɑ ɹ l ə m ə n t
parrot p ˈɛ ɹ ə t
participate p ɑ ɹ t ˈɪ s ə p ˌeɪ t
particle p ˈɑ ɹ t ɪ k ə l
passage p ˈæ s ɪ d͡ʒ
passion p ˈæ ʃ ə n
passport p ˈæ s p ˌɔ ɹ t
password p ˈæ s w ˌɚ d
pasta p ˈɑ s t ə
paste p ˈeɪ s t
pastry p ˈeɪ s t ɹ i
pat p ˈæ t
patch p ˈæ t͡ʃ
patience p ˈeɪ ʃ ə n s
patrol p ə t ɹ ˈoʊ l
pause p ˈɔ z
pave p ˈeɪ v
paw p ˈɔ
payment p ˈeɪ m ə n t
pea p ˈi
peaceful p ˈi s f ə l
peach p ˈi t͡ʃ
peak p ˈi k
peanut p ˈi n ˌʌ t
pear p ˈɛ ɹ
pearl p ˈɚ l
peasant p ˈɛ z ə n t
peculiar p ə k j ˈu l j ɚ
pedal p ˈɛ d ə l
peel p ˈi l
peer p ˈɪ ɹ
penalty p ˈɛ n ə l t i
penny p ˈɛ n i
pension p ˈɛ n ʃ ə n
pepper p ˈɛ p ɚ
percent p ɚ s ˈɛ n t
percentage p ɚ s ˈɛ n t ɪ d͡ʒ
perception p ɚ s ˈɛ p ʃ ə n
performance p ɚ f ˈɔ ɹ m ə n s
perfume p ɚ f j ˈu m
permanent p ˈɚ m ə n ə n t
permission p ɚ m ˈɪ ʃ ə n
personality p ˌɚ s ə n ˈæ l ə t i
perspective p ɚ s p ˈɛ k t ɪ v
persuade p ɚ s w ˈeɪ d
pet p ˈɛ t
petrol p ˈɛ t ɹ ə l
phase f ˈeɪ z
phenomenon f ə n ˈɑ m ə n ˌɑ n
philosophy f ə l ˈɑ s ə f i
photograph f ˈoʊ t ə ɡ ɹ ˌæ f
photographer f ə t ˈɑ ɡ ɹ ə f ɚ
physician f ə z ˈɪ ʃ ə n
physics f ˈɪ z ɪ k s
pickle p ˈɪ k ə l
picnic p ˈɪ k n ɪ k
pie p ˈaɪ
pig p ˈɪ ɡ
pigeon p ˈɪ d͡ʒ ə n
pile p ˈaɪ l
pill p ˈɪ l
pillow p ˈɪ l oʊ
pilot p ˈaɪ l ə t
pin p ˈɪ n
pinch p ˈɪ n t͡ʃ
pine p ˈaɪ n
pineapple p ˈaɪ n ˌæ p ə l
pint p ˈaɪ n t
pioneer p ˌaɪ ə n ˈɪ ɹ
pipe p ˈaɪ p
pirate p ˈaɪ ɹ ə t
pistol p ˈɪ s t ə l
pit p ˈɪ t
pitch p ˈɪ t͡ʃ
pity p ˈɪ t i
pizza p ˈi t s ə
plain p l ˈeɪ n
platform p l ˈæ t f ˌɔ ɹ m
pleasant p l ˈɛ z ə n t
plenty p l ˈɛ n t i
plot p l ˈɑ t
plow p l ˈaʊ
plug p l ˈʌ ɡ
plum p l ˈʌ m
plumber p l ˈʌ m ɚ
plunge p l ˈʌ n d͡ʒ
plus p l ˈʌ s
poet p ˈoʊ ə t
geology d͡ʒ i ˈɑ l ə d͡ʒ i
photography f ə t ˈɑ ɡ ɹ ə f i
anatomy ə n ˈæ t ə m i
celebrity s ə l ˈɛ b ɹ ə t i
mysterious m ɪ s t ˈɪ ɹ i ə s
mystery m ˈɪ s t ɚ i
encyclopedia ɪ n s ˌaɪ k l ə p ˈi d i ə
association ə s ˌoʊ s i ˈeɪ ʃ ə n
poetry p ˈoʊ ə t ɹ i
poison p ˈɔɪ z ə n
pole p ˈoʊ l
polish p ˈɑ l ɪ ʃ
polite p ə l ˈaɪ t
politician p ˌɑ l ə t ˈɪ ʃ ə n
pollution p ə l ˈu ʃ ə n
pond p ˈɑ n d
pony p ˈoʊ n i
pop p ˈɑ p
porch p ˈɔ ɹ t͡ʃ
port p ˈɔ ɹ t
porter p ˈɔ ɹ t ɚ
portion p ˈɔ ɹ ʃ ə n
portrait p ˈɔ ɹ t ɹ ə t
pose p ˈoʊ z
possess p ə z ˈɛ s
possession p ə z ˈɛ ʃ ə n
possibility p ˌɑ s ə b ˈɪ l ə t i
post p ˈoʊ s t
postage p ˈoʊ s t ɪ d͡ʒ
postpone p oʊ s t p ˈoʊ n
pot p ˈɑ t
potato p ə t ˈeɪ t oʊ
potential p ə t ˈɛ n ʃ ə l
pour p ˈɔ ɹ
poverty p ˈɑ v ɚ t i
powder p ˈaʊ d ɚ
practical p ɹ ˈæ k t ɪ k ə l
praise p ɹ ˈeɪ z
pray p ɹ ˈeɪ
prayer p ɹ ˈɛ ɹ
preach p ɹ ˈi t͡ʃ
precious p ɹ ˈɛ ʃ ə s
precise p ɹ ɪ s ˈaɪ s
predict p ɹ ɪ d ˈɪ k t
prefer p ɹ ɪ f ˈɚ
pregnant p ɹ ˈɛ ɡ n ə n t
preparation p ɹ ˌɛ p ə ɹ ˈeɪ ʃ ə n
presence p ɹ ˈɛ z ə n s
presentation p ɹ ˌɛ z ə n t ˈeɪ ʃ ə n
preserve p ɹ ɪ z ˈɚ v
pretend p ɹ ɪ t ˈɛ n d
previous p ɹ ˈi v i ə s
prey p ɹ ˈeɪ
priest p ɹ ˈi s t
primary p ɹ ˈaɪ m ˌɛ ɹ i
prime p ɹ ˈaɪ m
prince p ɹ ˈɪ n s
princess p ɹ ˈɪ n s ɛ s
principal p ɹ ˈɪ n s ə p ə l
principle p ɹ ˈɪ n s ə p ə l
print p ɹ ˈɪ n t
printer p ɹ ˈɪ n t ɚ
priority p ɹ aɪ ˈɔ ɹ ə t i
prison p ɹ ˈɪ z ə n
prisoner p ɹ ˈɪ z ə n ɚ
privacy p ɹ ˈaɪ v ə s i
privilege p ɹ ˈɪ v ə l ɪ d͡ʒ
probable p ɹ ˈɑ b ə b ə l
procedure p ɹ ə s ˈi d͡ʒ ɚ
proceed p ɹ ə s ˈi d
procession p ɹ ə s ˈɛ ʃ ə n
production p ɹ ə d ˈʌ k ʃ ə n
profession p ɹ ə f ˈɛ ʃ ə n
professional p ɹ ə f ˈɛ ʃ ə n ə l
profile p ɹ ˈoʊ f aɪ l
profit p ɹ ˈɑ f ə t
prohibit p ɹ oʊ h ˈɪ b ə t
prominent p ɹ ˈɑ m ə n ə n t
promote p ɹ ə m ˈoʊ t
prompt p ɹ ˈɑ m p t
pronounce p ɹ ə n ˈaʊ n s
proof p ɹ ˈu f
proper p ɹ ˈɑ p ɚ
property p ɹ ˈɑ p ɚ t i
proportion p ɹ ə p ˈɔ ɹ ʃ ə n
proposal p ɹ ə p ˈoʊ z ə l
propose p ɹ ə p ˈoʊ z
prospect p ɹ ˈɑ s p ɛ k t
protection p ɹ ə t ˈɛ k ʃ ə n
protein p ɹ ˈoʊ t i n
proverb p ɹ ˈɑ v ɚ b
province p ɹ ˈɑ v ə n s
provision p ɹ ə v ˈɪ ʒ ə n
psychology s aɪ k ˈɑ l ə d͡ʒ i
pub p ˈʌ b
publication p ˌʌ b l ə k ˈeɪ ʃ ə n
publish p ˈʌ b l ɪ ʃ
publisher p ˈʌ b l ɪ ʃ ɚ
pudding p ˈʊ d ɪ ŋ
puddle p ˈʌ d ə l
pump p ˈʌ m p
pumpkin p ˈʌ m p k ə n
punch p ˈʌ n t͡ʃ
punish p ˈʌ n ɪ ʃ
punishment p ˈʌ n ɪ ʃ m ə n t
pupil p j ˈu p ə l
puppy p ˈʌ p i
purchase p ˈɚ t͡ʃ ə s
pure p j ˈʊ ɹ
purple p ˈɚ p ə l
purse p ˈɚ s
pursue p ɚ s ˈu
puzzle p ˈʌ z ə l
qualify k w ˈɑ l ə f ˌaɪ
quantity k w ˈɑ n t ə t i
quarrel k w ˈɔ ɹ ə l
quart k w ˈɔ ɹ t
quest k w ˈɛ s t
quit k w ˈɪ t
quote k w ˈoʊ t
rack ɹ ˈæ k
radar ɹ ˈeɪ d ɑ ɹ
radical ɹ ˈæ d ɪ k ə l
rag ɹ ˈæ ɡ
rage ɹ ˈeɪ d͡ʒ
raid ɹ ˈeɪ d
rail ɹ ˈeɪ l
railroad ɹ ˈeɪ l ɹ ˌoʊ d
railway ɹ ˈeɪ l w ˌeɪ
rainbow ɹ ˈeɪ n b ˌoʊ
raisin ɹ ˈeɪ z ə n
rake ɹ ˈeɪ k
rally ɹ ˈæ l i
ranch ɹ ˈæ n t͡ʃ
random ɹ ˈæ n d ə m
rank ɹ ˈæ ŋ k
rapid ɹ ˈæ p ə d
rare ɹ ˈɛ ɹ
rat ɹ ˈæ t
ratio ɹ ˈeɪ ʃ i ˌoʊ
raw ɹ ˈɔ
ray ɹ ˈeɪ
razor ɹ ˈeɪ z ɚ
reader ɹ ˈi d ɚ
reality ɹ i ˈæ l ə t i
rear ɹ ˈɪ ɹ
reasonable ɹ ˈi z ə n ə b ə l
recall ɹ ɪ k ˈɔ l
receipt ɹ ɪ s ˈi t
recipe ɹ ˈɛ s ə p i
recognition ɹ ˌɛ k ə ɡ n ˈɪ ʃ ə n
recommend ɹ ˌɛ k ə m ˈɛ n d
recover ɹ ɪ k ˈʌ v ɚ
recovery ɹ ɪ k ˈʌ v ɚ i
reduction ɹ ɪ d ˈʌ k ʃ ə n
refer ɹ ɪ f ˈɚ
reference ɹ ˈɛ f ɹ ə n s
reflection ɹ ɪ f l ˈɛ k ʃ ə n
reform ɹ ɪ f ˈɔ ɹ m
refrigerator ɹ ɪ f ɹ ˈɪ d͡ʒ ə ɹ ˌeɪ t ɚ
refugee ɹ ˌɛ f j u d͡ʒ ˈi
regard ɹ ɪ ɡ ˈɑ ɹ d
regime ɹ ə ʒ ˈi m
register ɹ ˈɛ d͡ʒ ə s t ɚ
regret ɹ ɪ ɡ ɹ ˈɛ t
regular ɹ ˈɛ ɡ j ə l ɚ
regulation ɹ ˌɛ ɡ j ə l ˈeɪ ʃ ə n
rehearse ɹ ɪ h ˈɚ s
reign ɹ ˈeɪ n
rein ɹ ˈeɪ n
relate ɹ ɪ l ˈeɪ t
relation ɹ ɪ l ˈeɪ ʃ ə n
relative ɹ ˈɛ l ə t ɪ v
relax ɹ ɪ l ˈæ k s
relevant ɹ ˈɛ l ə v ə n t
relief ɹ ɪ l ˈi f
relieve ɹ ɪ l ˈi v
religious ɹ ɪ l ˈɪ d͡ʒ ə s
rely ɹ ɪ l ˈaɪ
remark ɹ ɪ m ˈɑ ɹ k
remarkable ɹ ɪ m ˈɑ ɹ k ə b ə l
remedy ɹ ˈɛ m ə d i
remind ɹ ɪ m ˈaɪ n d
remote ɹ ɪ m ˈoʊ t
removal ɹ ɪ m ˈu v ə l
rent ɹ ˈɛ n t
repair ɹ ɪ p ˈɛ ɹ
reply ɹ ɪ p l ˈaɪ
reporter ɹ ɪ p ˈɔ ɹ t ɚ
representative ɹ ˌɛ p ɹ ɪ z ˈɛ n t ə t ɪ v
reproduce ɹ ˌi p ɹ ə d ˈu s
reptile ɹ ˈɛ p t aɪ l
republic ɹ ɪ p ˈʌ b l ɪ k
reputation ɹ ˌɛ p j ə t ˈeɪ ʃ ə n
request ɹ ɪ k w ˈɛ s t
requirement ɹ ɪ k w ˈaɪ ɚ m ə n t
rescue ɹ ˈɛ s k j u
resemble ɹ ɪ z ˈɛ m b ə l
reservation ɹ ˌɛ z ɚ v ˈeɪ ʃ ə n
reserve ɹ ɪ z ˈɚ v
residence ɹ ˈɛ z ə d ə n s
resident ɹ ˈɛ z ə d ə n t
resign ɹ ɪ z ˈaɪ n
resist ɹ ɪ z ˈɪ s t
resistance ɹ ɪ z ˈɪ s t ə n s
resolution ɹ ˌɛ z ə l ˈu ʃ ə n
resolve ɹ ɪ z ˈɑ l v
resort ɹ ɪ z ˈɔ ɹ t
responsible ɹ ɪ s p ˈɑ n s ə b ə l
restaurant ɹ ˈɛ s t ə ɹ ˌɑ n t
restore ɹ ɪ s t ˈɔ ɹ
restrict ɹ ɪ s t ɹ ˈɪ k t
resume ɹ ɪ z ˈu m
retail ɹ ˈi t eɪ l
retain ɹ ɪ t ˈeɪ n
retire ɹ ɪ t ˈaɪ ɚ
retreat ɹ ɪ t ɹ ˈi t
revenge ɹ ɪ v ˈɛ n d͡ʒ
revenue ɹ ˈɛ v ə n ˌu
reverse ɹ ɪ v ˈɚ s
revolution ɹ ˌɛ v ə l ˈu ʃ ə n
reward ɹ ɪ w ˈɔ ɹ d
rhythm ɹ ˈɪ ð ə m
rib ɹ ˈɪ b
ribbon ɹ ˈɪ b ə n
rice ɹ ˈaɪ s
rid ɹ ˈɪ d
riddle ɹ ˈɪ d ə l
ridge ɹ ˈɪ d͡ʒ
ridiculous ɹ ɪ d ˈɪ k j ə l ə s
rifle ɹ ˈaɪ f ə l
rigid ɹ ˈɪ d͡ʒ ə d
rim ɹ ˈɪ m
riot ɹ ˈaɪ ə t
rip ɹ ˈɪ p
ripe ɹ ˈaɪ p
rival ɹ ˈaɪ v ə l
roar ɹ ˈɔ ɹ
roast ɹ ˈoʊ s t
rob ɹ ˈɑ b
robot ɹ ˈoʊ b ɑ t
rocket ɹ ˈɑ k ə t
rod ɹ ˈɑ d
role ɹ ˈoʊ l
roll ɹ ˈoʊ l
roof ɹ ˈu f
root ɹ ˈu t
rope ɹ ˈoʊ p
rose ɹ ˈoʊ z
rot ɹ ˈɑ t
rough ɹ ˈʌ f
route ɹ ˈu t
routine ɹ u t ˈi n
row ɹ ˈoʊ
royal ɹ ˈɔɪ ə l
rub ɹ ˈʌ b
rubber ɹ ˈʌ b ɚ
rude ɹ ˈu d
rug ɹ ˈʌ ɡ
ruin ɹ ˈu ə n
rumor ɹ ˈu m ɚ
rural ɹ ˈʊ ɹ ə l
rust ɹ ˈʌ s t
sack s ˈæ k
sacred s ˈeɪ k ɹ ə d
sacrifice s ˈæ k ɹ ə f ˌaɪ s
saddle s ˈæ d ə l
sail s ˈeɪ l
sailor s ˈeɪ l ɚ
saint s ˈeɪ n t
sake s ˈeɪ k
salad s ˈæ l ə d
salary s ˈæ l ɚ i
sale s ˈeɪ l
salmon s ˈæ m ə n
sample s ˈæ m p ə l
sandwich s ˈæ n d w ɪ t͡ʃ
satellite s ˈæ t ə l ˌaɪ t
satisfaction s ˌæ t ə s f ˈæ k ʃ ə n
satisfactory s ˌæ t ə s f ˈæ k t ɚ i
satisfy s ˈæ t ə s f ˌaɪ
sauce s ˈɔ s
saucer s ˈɔ s ɚ
sausage s ˈɔ s ɪ d͡ʒ
scan s k ˈæ n
scandal s k ˈæ n d ə l
scar s k ˈɑ ɹ
scarce s k ˈɛ ɹ s
scare s k ˈɛ ɹ
scarf s k ˈɑ ɹ f
scatter s k ˈæ t ɚ
scenario s ə n ˈɛ ɹ i ˌoʊ
scenery s ˈi n ɚ i
schedule s k ˈɛ d͡ʒ u l
scheme s k ˈi m
scholar s k ˈɑ l ɚ
scholarship s k ˈɑ l ɚ ʃ ˌɪ p
scientific s ˌaɪ ə n t ˈɪ f ɪ k
scissors s ˈɪ z ɚ z
scold s k ˈoʊ l d
scoop s k ˈu p
scope s k ˈoʊ p
scorn s k ˈɔ ɹ n
scout s k ˈaʊ t
scrap s k ɹ ˈæ p
scrape s k ɹ ˈeɪ p
scratch s k ɹ ˈæ t͡ʃ
scream s k ɹ ˈi m
screw s k ɹ ˈu
script s k ɹ ˈɪ p t
scrub s k ɹ ˈʌ b
sculpture s k ˈʌ l p t͡ʃ ɚ
seal s ˈi l
seaside s ˈi s ˌaɪ d
secondary s ˈɛ k ə n d ˌɛ ɹ i
secretary s ˈɛ k ɹ ə t ˌɛ ɹ i
sector s ˈɛ k t ɚ
secure s ə k j ˈʊ ɹ
seed s ˈi d
seek s ˈi k
seize s ˈi z
seldom s ˈɛ l d ə m
select s ə l ˈɛ k t
selection s ə l ˈɛ k ʃ ə n
self s ˈɛ l f
selfish s ˈɛ l f ɪ ʃ
semester s ə m ˈɛ s t ɚ
senate s ˈɛ n ə t
senator s ˈɛ n ə t ɚ
sensation s ɛ n s ˈeɪ ʃ ə n
sensible s ˈɛ n s ə b ə l
sensitive s ˈɛ n s ə t ɪ v
separation s ˌɛ p ə ɹ ˈeɪ ʃ ə n
sequence s ˈi k w ə n s
servant s ˈɚ v ə n t
session s ˈɛ ʃ ə n
settlement s ˈɛ t ə l m ə n t
severe s ə v ˈɪ ɹ
sew s ˈoʊ
shade ʃ ˈeɪ d
shadow ʃ ˈæ d oʊ
shaft ʃ ˈæ f t
shall ʃ ˈæ l
shallow ʃ ˈæ l oʊ
shame ʃ ˈeɪ m
shampoo ʃ æ m p ˈu
shark ʃ ˈɑ ɹ k
shave ʃ ˈeɪ v
shed ʃ ˈɛ d
sheep ʃ ˈi p
sheet ʃ ˈi t
shelf ʃ ˈɛ l f
shell ʃ ˈɛ l
shelter ʃ ˈɛ l t ɚ
shepherd ʃ ˈɛ p ɚ d
shield ʃ ˈi l d
shift ʃ ˈɪ f t
shine ʃ ˈaɪ n
shiny ʃ ˈaɪ n i
shirt ʃ ˈɚ t
shock ʃ ˈɑ k
shore ʃ ˈɔ ɹ
shortage ʃ ˈɔ ɹ t ɪ d͡ʒ
shortly ʃ ˈɔ ɹ t l i
shot ʃ ˈɑ t
shove ʃ ˈʌ v
shovel ʃ ˈʌ v ə l
shower ʃ ˈaʊ ɚ
shrimp ʃ ɹ ˈɪ m p
shrink ʃ ɹ ˈɪ ŋ k
shrug ʃ ɹ ˈʌ ɡ
shy ʃ ˈaɪ
sigh s ˈaɪ
signature s ˈɪ ɡ n ə t͡ʃ ɚ
significance s ɪ ɡ n ˈɪ f ɪ k ə n s
significant s ɪ ɡ n ˈɪ f ɪ k ə n t
silk s ˈɪ l k
silly s ˈɪ l i
sin s ˈɪ n
sincere s ɪ n s ˈɪ ɹ
singer s ˈɪ ŋ ɚ
sink s ˈɪ ŋ k
sip s ˈɪ p
site s ˈaɪ t
sixth s ˈɪ k s θ
skate s k ˈeɪ t
skeleton s k ˈɛ l ə t ə n
sketch s k ˈɛ t͡ʃ
ski s k ˈi
skip s k ˈɪ p
skirt s k ˈɚ t
skull s k ˈʌ l
slam s l ˈæ m
slap s l ˈæ p
slave s l ˈeɪ v
sled s l ˈɛ d
sleeve s l ˈi v
slender s l ˈɛ n d ɚ
slice s l ˈaɪ s
slide s l ˈaɪ d
slight s l ˈaɪ t
slightly s l ˈaɪ t l i
slim s l ˈɪ m
slip s l ˈɪ p
slipper s l ˈɪ p ɚ
slope s l ˈoʊ p
slot s l ˈɑ t
smash s m ˈæ ʃ
smell s m ˈɛ l
smooth s m ˈu ð
snack s n ˈæ k
snake s n ˈeɪ k
snap s n ˈæ p
sneeze s n ˈi z
sniff s n ˈɪ f
soak s ˈoʊ k
soap s ˈoʊ p
soccer s ˈɑ k ɚ
sock s ˈɑ k
soda s ˈoʊ d ə
sofa s ˈoʊ f ə
solar s ˈoʊ l ɚ
sole s ˈoʊ l
solid s ˈɑ l ə d
somehow s ˈʌ m h ˌaʊ
sore s ˈɔ ɹ
sorrow s ˈɑ ɹ oʊ
soul s ˈoʊ l
soup s ˈu p
sour s ˈaʊ ɚ
southern s ˈʌ ð ɚ n
spade s p ˈeɪ d
spare s p ˈɛ ɹ
spark s p ˈɑ ɹ k
sparrow s p ˈɛ ɹ oʊ
speaker s p ˈi k ɚ
spear s p ˈɪ ɹ
specialist s p ˈɛ ʃ ə l ə s t
species s p ˈi ʃ i z
spectacle s p ˈɛ k t ə k ə l
speed s p ˈi d
spell s p ˈɛ l
sphere s f ˈɪ ɹ
spice s p ˈaɪ s
spider s p ˈaɪ d ɚ
spill s p ˈɪ l
spin s p ˈɪ n
spine s p ˈaɪ n
spiritual s p ˈɪ ɹ ɪ t͡ʃ u ə l
spit s p ˈɪ t
spite s p ˈaɪ t
splash s p l ˈæ ʃ
splendid s p l ˈɛ n d ə d
split s p l ˈɪ t
spoil s p ˈɔɪ l
sponsor s p ˈɑ n s ɚ
spoon s p ˈu n
spray s p ɹ ˈeɪ
sprinkle s p ɹ ˈɪ ŋ k ə l
spy s p ˈaɪ
squad s k w ˈɑ d
square s k w ˈɛ ɹ
squeeze s k w ˈi z
squirrel s k w ˈɚ ə l
stab s t ˈæ b
stable s t ˈeɪ b ə l
stack s t ˈæ k
stadium s t ˈeɪ d i ə m
stake s t ˈeɪ k
stale s t ˈeɪ l
stamp s t ˈæ m p
stare s t ˈɛ ɹ
starve s t ˈɑ ɹ v
statement s t ˈeɪ t m ə n t
statistics s t ə t ˈɪ s t ɪ k s
statue s t ˈæ t͡ʃ u
steady s t ˈɛ d i
steak s t ˈeɪ k
steal s t ˈi l
steam s t ˈi m
steel s t ˈi l
steep s t ˈi p
steer s t ˈɪ ɹ
stem s t ˈɛ m
stiff s t ˈɪ f
stimulate s t ˈɪ m j ə l ˌeɪ t
sting s t ˈɪ ŋ
stir s t ˈɚ
stitch s t ˈɪ t͡ʃ
stocking s t ˈɑ k ɪ ŋ
stomach s t ˈʌ m ə k
stoop s t ˈu p
storage s t ˈɔ ɹ ɪ d͡ʒ
stove s t ˈoʊ v
strain s t ɹ ˈeɪ n
strap s t ɹ ˈæ p
strategy s t ɹ ˈæ t ə d͡ʒ i
straw s t ɹ ˈɔ
strawberry s t ɹ ˈɔ b ˌɛ ɹ i
strict s t ɹ ˈɪ k t
string s t ɹ ˈɪ ŋ
strip s t ɹ ˈɪ p
stripe s t ɹ ˈaɪ p
stroke s t ɹ ˈoʊ k
struggle s t ɹ ˈʌ ɡ ə l
stubborn s t ˈʌ b ɚ n
studio s t ˈu d i ˌoʊ
stuff s t ˈʌ f
stumble s t ˈʌ m b ə l
submit s ə b m ˈɪ t
substance s ˈʌ b s t ə n s
substantial s ə b s t ˈæ n ʃ ə l
substitute s ˈʌ b s t ə t ˌu t
subtle s ˈʌ t ə l
subtract s ə b t ɹ ˈæ k t
suburb s ˈʌ b ɚ b
subway s ˈʌ b w ˌeɪ
succeed s ə k s ˈi d
suck s ˈʌ k
sufficient s ə f ˈɪ ʃ ə n t
suggestion s ə ɡ d͡ʒ ˈɛ s t͡ʃ ə n
suit s ˈu t
suitable s ˈu t ə b ə l
suitcase s ˈu t k ˌeɪ s
sum s ˈʌ m
summary s ˈʌ m ɚ i
summit s ˈʌ m ə t
sunrise s ˈʌ n ɹ ˌaɪ z
sunset s ˈʌ n s ˌɛ t
sunshine s ˈʌ n ʃ ˌaɪ n
superior s u p ˈɪ ɹ i ɚ
supermarket s ˈu p ɚ m ˌɑ ɹ k ə t
supper s ˈʌ p ɚ
supreme s u p ɹ ˈi m
surgeon s ˈɚ d͡ʒ ə n
surgery s ˈɚ d͡ʒ ɚ i
surplus s ˈɚ p l ʌ s
surround s ə ɹ ˈaʊ n d
survival s ɚ v ˈaɪ v ə l
suspicion s ə s p ˈɪ ʃ ə n
swallow s w ˈɑ l oʊ
swamp s w ˈɑ m p
swan s w ˈɑ n
swear s w ˈɛ ɹ
sweat s w ˈɛ t
sweater s w ˈɛ t ɚ
sweep s w ˈi p
swell s w ˈɛ l
swift s w ˈɪ f t
swing s w ˈɪ ŋ
sword s ˈɔ ɹ d
symbol s ˈɪ m b ə l
sympathy s ˈɪ m p ə θ i
symptom s ˈɪ m p t ə m
tab t ˈæ b
tablet t ˈæ b l ə t
tackle t ˈæ k ə l
tag t ˈæ ɡ
tailor t ˈeɪ l ɚ
tale t ˈeɪ l
talent t ˈæ l ə n t
tame t ˈeɪ m
tank t ˈæ ŋ k
tap t ˈæ p
tape t ˈeɪ p
taxi t ˈæ k s i
teaspoon t ˈi s p ˌu n
technical t ˈɛ k n ɪ k ə l
technique t ɛ k n ˈi k
teenager t ˈi n ˌeɪ d͡ʒ ɚ
telephone t ˈɛ l ə f ˌoʊ n
telescope t ˈɛ l ə s k ˌoʊ p
temper t ˈɛ m p ɚ
temple t ˈɛ m p ə l
temporary t ˈɛ m p ə ɹ ˌɛ ɹ i
tempt t ˈɛ m p t
tend t ˈɛ n d
tendency t ˈɛ n d ə n s i
tender t ˈɛ n d ɚ
tennis t ˈɛ n ə s
tense t ˈɛ n s
tension t ˈɛ n ʃ ə n
tent t ˈɛ n t
tenth t ˈɛ n θ
terrific t ə ɹ ˈɪ f ɪ k
territory t ˈɛ ɹ ə t ˌɔ ɹ i
terror t ˈɛ ɹ ɚ
texture t ˈɛ k s t͡ʃ ɚ
theater θ ˈi ə t ɚ
theme θ ˈi m
therapy θ ˈɛ ɹ ə p i
thief θ ˈi f
thirst θ ˈɚ s t
thread θ ɹ ˈɛ d
threaten θ ɹ ˈɛ t ə n
throne θ ɹ ˈoʊ n
thumb θ ˈʌ m
thunder θ ˈʌ n d ɚ
thus ð ˈʌ s
tide t ˈaɪ d
tidy t ˈaɪ d i
tiger t ˈaɪ ɡ ɚ
tight t ˈaɪ t
tile t ˈaɪ l
timber t ˈɪ m b ɚ
tin t ˈɪ n
tip t ˈɪ p
tire t ˈaɪ ɚ
tissue t ˈɪ ʃ u
toast t ˈoʊ s t
tobacco t ə b ˈæ k oʊ
toe t ˈoʊ
toilet t ˈɔɪ l ə t
tomato t ə m ˈeɪ t oʊ
tomb t ˈu m
ton t ˈʌ n
topic t ˈɑ p ɪ k
torch t ˈɔ ɹ t͡ʃ
torture t ˈɔ ɹ t͡ʃ ɚ
toss t ˈɔ s
tourist t ˈʊ ɹ ə s t
tournament t ˈʊ ɹ n ə m ə n t
towel t ˈaʊ ə l
tower t ˈaʊ ɚ
toy t ˈɔɪ
trace t ɹ ˈeɪ s
tractor t ɹ ˈæ k t ɚ
traditional t ɹ ə d ˈɪ ʃ ə n ə l
tragedy t ɹ ˈæ d͡ʒ ə d i
trail t ɹ ˈeɪ l
trailer t ɹ ˈeɪ l ɚ
trainer t ɹ ˈeɪ n ɚ
transform t ɹ æ n s f ˈɔ ɹ m
transition t ɹ æ n z ˈɪ ʃ ə n
translate t ɹ æ n z l ˈeɪ t
translation t ɹ æ n z l ˈeɪ ʃ ə n
transportation t ɹ ˌæ n s p ɚ t ˈeɪ ʃ ə n
trap t ɹ ˈæ p
trash t ɹ ˈæ ʃ
tray t ɹ ˈeɪ
treasure t ɹ ˈɛ ʒ ɚ
treaty t ɹ ˈi t i
tremble t ɹ ˈɛ m b ə l
tremendous t ɹ ə m ˈɛ n d ə s
trend t ɹ ˈɛ n d
triangle t ɹ ˈaɪ ˌæ ŋ ɡ ə l
tribe t ɹ ˈaɪ b
trick t ɹ ˈɪ k
trim t ɹ ˈɪ m
triumph t ɹ ˈaɪ ə m f
troop t ɹ ˈu p
trophy t ɹ ˈoʊ f i
tropical t ɹ ˈɑ p ɪ k ə l
trunk t ɹ ˈʌ ŋ k
tub t ˈʌ b
tube t ˈu b
tune t ˈu n
tunnel t ˈʌ n ə l
turkey t ˈɚ k i
turtle t ˈɚ t ə l
twin t w ˈɪ n
twist t w ˈɪ s t
typical t ˈɪ p ɪ k ə l
ultimate ˈʌ l t ə m ə t
umbrella ʌ m b ɹ ˈɛ l ə
unable ʌ n ˈeɪ b ə l
undergo ˌʌ n d ɚ ɡ ˈoʊ
underground ˈʌ n d ɚ ɡ ɹ ˌaʊ n d
underneath ˌʌ n d ɚ n ˈi θ
understanding ˌʌ n d ɚ s t ˈæ n d ɪ ŋ
underwear ˈʌ n d ɚ w ˌɛ ɹ
unemployment ˌʌ n ɪ m p l ˈɔɪ m ə n t
unexpected ˌʌ n ɪ k s p ˈɛ k t ə d
unfair ʌ n f ˈɛ ɹ
unfortunate ʌ n f ˈɔ ɹ t͡ʃ ə n ə t
unhappy ʌ n h ˈæ p i
uniform j ˈu n ə f ˌɔ ɹ m
union j ˈu n j ə n
unique j u n ˈi k
unite j u n ˈaɪ t
unity j ˈu n ə t i
universal j ˌu n ə v ˈɚ s ə l
universe j ˈu n ə v ˌɚ s
unknown ʌ n n ˈoʊ n
unlike ʌ n l ˈaɪ k
unlikely ʌ n l ˈaɪ k l i
unusual ʌ n j ˈu ʒ u ə l
upper ˈʌ p ɚ
urban ˈɚ b ə n
urge ˈɚ d͡ʒ
urgent ˈɚ d͡ʒ ə n t
useful j ˈu s f ə l
useless j ˈu s l ə s
user j ˈu z ɚ
utility j u t ˈɪ l ə t i
vacation v eɪ k ˈeɪ ʃ ə n
vacuum v ˈæ k j u m
vague v ˈeɪ ɡ
vain v ˈeɪ n
valid v ˈæ l ə d
valley v ˈæ l i
valuable v ˈæ l j ə b ə l
van v ˈæ n
vanish v ˈæ n ɪ ʃ
vary v ˈɛ ɹ i
vast v ˈæ s t
vegetable v ˈɛ d͡ʒ t ə b ə l
vein v ˈeɪ n
velvet v ˈɛ l v ə t
venture v ˈɛ n t͡ʃ ɚ
verb v ˈɚ b
verse v ˈɚ s
vertical v ˈɚ t ɪ k ə l
vessel v ˈɛ s ə l
veteran v ˈɛ t ɚ ə n
via v ˈaɪ ə
vibrate v ˈaɪ b ɹ eɪ t
vice v ˈaɪ s
victim v ˈɪ k t ə m
villain v ˈɪ l ə n
vine v ˈaɪ n
vinegar v ˈɪ n ə ɡ ɚ
violent v ˈaɪ ə l ə n t
violet v ˈaɪ ə l ə t
violin v ˌaɪ ə l ˈɪ n
virtue v ˈɚ t͡ʃ u
virus v ˈaɪ ɹ ə s
visible v ˈɪ z ə b ə l
vision v ˈɪ ʒ ə n
visitor v ˈɪ z ə t ɚ
visual v ˈɪ ʒ u ə l
vital v ˈaɪ t ə l
vitamin v ˈaɪ t ə m ə n
vivid v ˈɪ v ə d
vocabulary v oʊ k ˈæ b j ə l ˌɛ ɹ i
volcano v ɑ l k ˈeɪ n oʊ
volume v ˈɑ l j u m
voluntary v ˈɑ l ə n t ˌɛ ɹ i
volunteer v ˌɑ l ə n t ˈɪ ɹ
vote v ˈoʊ t
voyage v ˈɔɪ ɪ d͡ʒ
wage w ˈeɪ d͡ʒ
wagon w ˈæ ɡ ə n
waist w ˈeɪ s t
wake w ˈeɪ k
wallet w ˈɑ l ə t
wander w ˈɑ n d ɚ
warmth w ˈɔ ɹ m θ
warning w ˈɔ ɹ n ɪ ŋ
warrior w ˈɔ ɹ i ɚ
wasp w ˈɑ s p
wax w ˈæ k s
weak w ˈi k
weakness w ˈi k n ə s
wealth w ˈɛ l θ
wealthy w ˈɛ l θ i
weave w ˈi v
web w ˈɛ b
website w ˈɛ b s ˌaɪ t
wedding w ˈɛ d ɪ ŋ
weed w ˈi d
weekend w ˈi k ˌɛ n d
weekly w ˈi k l i
weep w ˈi p
weigh w ˈeɪ
weird w ˈɪ ɹ d
welfare w ˈɛ l f ˌɛ ɹ
whale w ˈeɪ l
wheat w ˈi t
whenever w ɛ n ˈɛ v ɚ
whereas w ɛ ɹ ˈæ z
wherever w ɛ ɹ ˈɛ v ɚ
whip w ˈɪ p
whistle w ˈɪ s ə l
whoever h u ˈɛ v ɚ
wicked w ˈɪ k ə d
widow w ˈɪ d oʊ
width w ˈɪ d θ
wilderness w ˈɪ l d ɚ n ə s
willing w ˈɪ l ɪ ŋ
wipe w ˈaɪ p
wire w ˈaɪ ɚ
wisdom w ˈɪ z d ə m
wise w ˈaɪ z
wit w ˈɪ t
witch w ˈɪ t͡ʃ
withdraw w ɪ ð d ɹ ˈɔ
witness w ˈɪ t n ə s
wolf w ˈʊ l f
wool w ˈʊ l
workshop w ˈɚ k ʃ ˌɑ p
worm w ˈɚ m
worship w ˈɚ ʃ ə p
worthy w ˈɚ ð i
wound w ˈu n d
wrap ɹ ˈæ p
wreck ɹ ˈɛ k
wrist ɹ ˈɪ s t
yarn j ˈɑ ɹ n
yawn j ˈɔ n
yearly j ˈɪ ɹ l i
yell j ˈɛ l
yield j ˈi l d
yogurt j ˈoʊ ɡ ɚ t
yolk j ˈoʊ k
zebra z ˈi b ɹ ə
zoo z ˈu
abundant ə b ˈʌ n d ə n t
accelerate æ k s ˈɛ l ə ɹ ˌeɪ t
accessible æ k s ˈɛ s ə b ə l
accommodate ə k ˈɑ m ə d ˌeɪ t
accomplishment ə k ˈɑ m p l ɪ ʃ m ə n t
accountant ə k ˈaʊ n t ə n t
accuracy ˈæ k j ɚ ə s i
acquisition ˌæ k w ə z ˈɪ ʃ ə n
adolescent ˌæ d ə l ˈɛ s ə n t
aesthetic ɛ s θ ˈɛ t ɪ k
affection ə f ˈɛ k ʃ ə n
aggressive ə ɡ ɹ ˈɛ s ɪ v
agony ˈæ ɡ ə n i
alert ə l ˈɚ t
algorithm ˈæ l ɡ ə ɹ ˌɪ ð ə m
alien ˈeɪ l i ə n
alliance ə l ˈaɪ ə n s
ally ˈæ l aɪ
ambassador æ m b ˈæ s ə d ɚ
ambitious æ m b ˈɪ ʃ ə s
amendment ə m ˈɛ n d m ə n t
ample ˈæ m p ə l
anticipate æ n t ˈɪ s ə p ˌeɪ t
anxiety æ ŋ z ˈaɪ ə t i
apparatus ˌæ p ə ɹ ˈæ t ə s
appliance ə p l ˈaɪ ə n s
applicant ˈæ p l ə k ə n t
appreciation ə p ɹ ˌi ʃ i ˈeɪ ʃ ə n
apprentice ə p ɹ ˈɛ n t ə s
arbitrary ˈɑ ɹ b ə t ɹ ˌɛ ɹ i
architecture ˈɑ ɹ k ə t ˌɛ k t͡ʃ ɚ
arena ə ɹ ˈi n ə
aristocrat ə ɹ ˈɪ s t ə k ɹ ˌæ t
arrogant ˈɛ ɹ ə ɡ ə n t
artery ˈɑ ɹ t ɚ i
assault ə s ˈɔ l t
assemble ə s ˈɛ m b ə l
assembly ə s ˈɛ m b l i
assess ə s ˈɛ s
asset ˈæ s ɛ t
assumption ə s ˈʌ m p ʃ ə n
astronaut ˈæ s t ɹ ə n ˌɔ t
astronomy ə s t ɹ ˈɑ n ə m i
atomic ə t ˈɑ m ɪ k
auction ˈɔ k ʃ ə n
audit ˈɔ d ə t
authentic ɔ θ ˈɛ n t ɪ k
autonomy ɔ t ˈɑ n ə m i
aviation ˌeɪ v i ˈeɪ ʃ ə n
bachelor b ˈæ t͡ʃ ə l ɚ
ballet b æ l ˈeɪ
bankruptcy b ˈæ ŋ k ɹ ʌ p t s i
banner b ˈæ n ɚ
barrier b ˈɛ ɹ i ɚ
basin b ˈeɪ s ə n
bass b ˈeɪ s
beverage b ˈɛ v ɹ ɪ d͡ʒ
bias b ˈaɪ ə s
bid b ˈɪ d
biography b aɪ ˈɑ ɡ ɹ ə f i
bolt b ˈoʊ l t
boost b ˈu s t
booth b ˈu θ
boulevard b ˈʊ l ə v ˌɑ ɹ d
bracket b ɹ ˈæ k ə t
breakdown b ɹ ˈeɪ k d ˌaʊ n
breakthrough b ɹ ˈeɪ k θ ɹ ˌu
browser b ɹ ˈaʊ z ɚ
brutal b ɹ ˈu t ə l
buckle b ˈʌ k ə l
buffer b ˈʌ f ɚ
bulk b ˈʌ l k
bureau b j ˈʊ ɹ oʊ
bureaucracy b j ʊ ɹ ˈɑ k ɹ ə s i
calculate k ˈæ l k j ə l ˌeɪ t
calculator k ˈæ l k j ə l ˌeɪ t ɚ
candid k ˈæ n d ə d
carbohydrate k ˌɑ ɹ b oʊ h ˈaɪ d ɹ eɪ t
cascade k æ s k ˈeɪ d
casualty k ˈæ ʒ u ə l t i
catastrophe k ə t ˈæ s t ɹ ə f i
cater k ˈeɪ t ɚ
cathedral k ə θ ˈi d ɹ ə l
cautious k ˈɔ ʃ ə s
cellular s ˈɛ l j ə l ɚ
ceramic s ə ɹ ˈæ m ɪ k
certainty s ˈɚ t ə n t i
certify s ˈɚ t ə f ˌaɪ
chronic k ɹ ˈɑ n ɪ k
chronicle k ɹ ˈɑ n ɪ k ə l
circuit s ˈɚ k ə t
circulate s ˈɚ k j ə l ˌeɪ t
citizenship s ˈɪ t ə z ə n ʃ ˌɪ p
clarify k l ˈɛ ɹ ə f ˌaɪ
clarity k l ˈɛ ɹ ə t i
classic k l ˈæ s ɪ k
classification k l ˌæ s ə f ə k ˈeɪ ʃ ə n
clause k l ˈɔ z
clinic k l ˈɪ n ɪ k
clinical k l ˈɪ n ɪ k ə l
cluster k l ˈʌ s t ɚ
cognitive k ˈɑ ɡ n ə t ɪ v
coherent k oʊ h ˈɪ ɹ ə n t
coincide k ˌoʊ ə n s ˈaɪ d
coincidence k oʊ ˈɪ n s ə d ə n s
collaborate k ə l ˈæ b ə ɹ ˌeɪ t
collapse k ə l ˈæ p s
collision k ə l ˈɪ ʒ ə n
colonial k ə l ˈoʊ n i ə l
commodity k ə m ˈɑ d ə t i
compass k ˈʌ m p ə s
compatible k ə m p ˈæ t ə b ə l
compel k ə m p ˈɛ l
compensate k ˈɑ m p ə n s ˌeɪ t
competent k ˈɑ m p ə t ə n t
compile k ə m p ˈaɪ l
complement k ˈɑ m p l ə m ə n t
complexity k ə m p l ˈɛ k s ə t i
compliance k ə m p l ˈaɪ ə n s
component k ə m p ˈoʊ n ə n t
comprehensive k ˌɑ m p ɹ ɪ h ˈɛ n s ɪ v
comprise k ə m p ɹ ˈaɪ z
conceive k ə n s ˈi v
concession k ə n s ˈɛ ʃ ə n
condemn k ə n d ˈɛ m
configuration k ə n f ˌɪ ɡ j ə ɹ ˈeɪ ʃ ə n
confine k ə n f ˈaɪ n
confront k ə n f ɹ ˈʌ n t
congratulate k ə n ɡ ɹ ˈæ t͡ʃ ə l ˌeɪ t
conjunction k ə n d͡ʒ ˈʌ ŋ k ʃ ə n
consensus k ə n s ˈɛ n s ə s
consent k ə n s ˈɛ n t
conservative k ə n s ˈɚ v ə t ɪ v
consolidate k ə n s ˈɑ l ə d ˌeɪ t
conspiracy k ə n s p ˈɪ ɹ ə s i
constituency k ə n s t ˈɪ t͡ʃ u ə n s i
constraint k ə n s t ɹ ˈeɪ n t
consultant k ə n s ˈʌ l t ə n t
consumption k ə n s ˈʌ m p ʃ ə n
contempt k ə n t ˈɛ m p t
contend k ə n t ˈɛ n d
contractor k ˈɑ n t ɹ æ k t ɚ
contradiction k ˌɑ n t ɹ ə d ˈɪ k ʃ ə n
contrary k ˈɑ n t ɹ ˌɛ ɹ i
controversial k ˌɑ n t ɹ ə v ˈɚ ʃ ə l
controversy k ˈɑ n t ɹ ə v ˌɚ s i
convention k ə n v ˈɛ n ʃ ə n
conversion k ə n v ˈɚ ʒ ə n
convey k ə n v ˈeɪ
conviction k ə n v ˈɪ k ʃ ə n
coordinate k oʊ ˈɔ ɹ d ə n ˌeɪ t
cope k ˈoʊ p
copyright k ˈɑ p i ɹ ˌaɪ t
corridor k ˈɔ ɹ ə d ɚ
corrupt k ə ɹ ˈʌ p t
corruption k ə ɹ ˈʌ p ʃ ə n
cosmetic k ɑ z m ˈɛ t ɪ k
counsel k ˈaʊ n s ə l
courtesy k ˈɚ t ə s i
craftsman k ɹ ˈæ f t s m ə n
credibility k ɹ ˌɛ d ə b ˈɪ l ə t i
critique k ɹ ɪ t ˈi k
crucial k ɹ ˈu ʃ ə l
crude k ɹ ˈu d
cruise k ɹ ˈu z
cumulative k j ˈu m j ə l ə t ɪ v
curiosity k j ˌʊ ɹ i ˈɑ s ə t i
curriculum k ə ɹ ˈɪ k j ə l ə m
cynical s ˈɪ n ɪ k ə l
deadline d ˈɛ d l ˌaɪ n
debris d ə b ɹ ˈi
decent d ˈi s ə n t
dedicate d ˈɛ d ə k ˌeɪ t
deduce d ɪ d ˈu s
default d ɪ f ˈɔ l t
deficit d ˈɛ f ə s ə t
dense d ˈɛ n s
density d ˈɛ n s ə t i
designate d ˈɛ z ɪ ɡ n ˌeɪ t
detach d ɪ t ˈæ t͡ʃ
deteriorate d ɪ t ˈɪ ɹ i ə ɹ ˌeɪ t
diagnosis d ˌaɪ ə ɡ n ˈoʊ s ə s
dialect d ˈaɪ ə l ˌɛ k t
dictate d ˈɪ k t eɪ t
dignity d ˈɪ ɡ n ə t i
dilemma d ə l ˈɛ m ə
dimension d ə m ˈɛ n ʃ ə n
diminish d ə m ˈɪ n ɪ ʃ
diplomat d ˈɪ p l ə m ˌæ t
disability d ˌɪ s ə b ˈɪ l ə t i
discourse d ˈɪ s k ɔ ɹ s
discretion d ɪ s k ɹ ˈɛ ʃ ə n
dismay d ɪ s m ˈeɪ
disorder d ɪ s ˈɔ ɹ d ɚ
dispatch d ɪ s p ˈæ t͡ʃ
displace d ɪ s p l ˈeɪ s
disposal d ɪ s p ˈoʊ z ə l
dispose d ɪ s p ˈoʊ z
dispute d ɪ s p j ˈu t
disrupt d ɪ s ɹ ˈʌ p t
dissolve d ɪ z ˈɑ l v
distress d ɪ s t ɹ ˈɛ s
diverse d aɪ v ˈɚ s
diversity d aɪ v ˈɚ s ə t i
dividend d ˈɪ v ə d ˌɛ n d
doctrine d ˈɑ k t ɹ ə n
donor d ˈoʊ n ɚ
dose d ˈoʊ s
draft d ɹ ˈæ f t
drastic d ɹ ˈæ s t ɪ k
dual d ˈu ə l
dubious d ˈu b i ə s
durable d ˈʊ ɹ ə b ə l
duration d ʊ ɹ ˈeɪ ʃ ə n
dynasty d ˈaɪ n ə s t i
eclipse ɪ k l ˈɪ p s
ecology ɪ k ˈɑ l ə d͡ʒ i
ecosystem ˈi k oʊ s ˌɪ s t ə m
elaborate ɪ l ˈæ b ɚ ə t
eligible ˈɛ l ə d͡ʒ ə b ə l
eloquent ˈɛ l ə k w ə n t
embassy ˈɛ m b ə s i
embrace ɪ m b ɹ ˈeɪ s
emission ə m ˈɪ ʃ ə n
empirical ɪ m p ˈɪ ɹ ɪ k ə l
enact ɪ n ˈæ k t
endeavor ɪ n d ˈɛ v ɚ
endorse ɪ n d ˈɔ ɹ s
endure ɪ n d ˈʊ ɹ
enforce ɪ n f ˈɔ ɹ s
enhance ɪ n h ˈæ n s
enterprise ˈɛ n t ɚ p ɹ ˌaɪ z
entity ˈɛ n t ə t i
entrepreneur ˌɑ n t ɹ ə p ɹ ə n ˈɚ
epidemic ˌɛ p ə d ˈɛ m ɪ k
equity ˈɛ k w ə t i
equivalent ɪ k w ˈɪ v ə l ə n t
erosion ɪ ɹ ˈoʊ ʒ ə n
eternal ɪ t ˈɚ n ə l
ethical ˈɛ θ ɪ k ə l
ethics ˈɛ θ ɪ k s
ethnic ˈɛ θ n ɪ k
evacuate ɪ v ˈæ k j u ˌeɪ t
evolve ɪ v ˈɑ l v
exaggerate ɪ ɡ z ˈæ d͡ʒ ə ɹ ˌeɪ t
excerpt ˈɛ k s ɚ p t
exclusive ɪ k s k l ˈu s ɪ v
execute ˈɛ k s ə k j ˌu t
executive ɪ ɡ z ˈɛ k j ə t ɪ v
exempt ɪ ɡ z ˈɛ m p t
exile ˈɛ ɡ z aɪ l
expire ɪ k s p ˈaɪ ɚ
explicit ɪ k s p l ˈɪ s ə t
exploit ɪ k s p l ˈɔɪ t
exquisite ɪ k s k w ˈɪ z ə t
extinct ɪ k s t ˈɪ ŋ k t
extract ɪ k s t ɹ ˈæ k t
fabulous f ˈæ b j ə l ə s
facilitate f ə s ˈɪ l ə t ˌeɪ t
facility f ə s ˈɪ l ə t i
faction f ˈæ k ʃ ə n
faculty f ˈæ k ə l t i
fatigue f ə t ˈi ɡ
feasible f ˈi z ə b ə l
federation f ˌɛ d ə ɹ ˈeɪ ʃ ə n
feedback f ˈi d b ˌæ k
fertile f ˈɚ t ə l
fiscal f ˈɪ s k ə l
flaw f l ˈɔ
fluctuate f l ˈʌ k t͡ʃ u ˌeɪ t
forge f ˈɔ ɹ d͡ʒ
fragment f ɹ ˈæ ɡ m ə n t
framework f ɹ ˈeɪ m w ˌɚ k
franchise f ɹ ˈæ n t͡ʃ aɪ z
fraud f ɹ ˈɔ d
frontier f ɹ ʌ n t ˈɪ ɹ
fusion f j ˈu ʒ ə n
futile f j ˈu t ə l
gauge ɡ ˈeɪ d͡ʒ
gender d͡ʒ ˈɛ n d ɚ
genetic d͡ʒ ə n ˈɛ t ɪ k
genome d͡ʒ ˈi n oʊ m
glacier ɡ l ˈeɪ ʃ ɚ
gland ɡ l ˈæ n d
glimpse ɡ l ˈɪ m p s
gloom ɡ l ˈu m
gorgeous ɡ ˈɔ ɹ d͡ʒ ə s
gospel ɡ ˈɑ s p ə l
gourmet ɡ ʊ ɹ m ˈeɪ
graffiti ɡ ɹ ə f ˈi t i
gratitude ɡ ɹ ˈæ t ə t ˌu d
gravel ɡ ɹ ˈæ v ə l
grid ɡ ɹ ˈɪ d
grill ɡ ɹ ˈɪ l
guardian ɡ ˈɑ ɹ d i ə n
gut ɡ ˈʌ t
habitat h ˈæ b ə t ˌæ t
hierarchy h ˈaɪ ə ɹ ˌɑ ɹ k i
hostage h ˈɑ s t ɪ d͡ʒ
hostile h ˈɑ s t ə l
humidity h j u m ˈɪ d ə t i
hygiene h ˈaɪ d͡ʒ i n
hypothesis h aɪ p ˈɑ θ ə s ə s
identical aɪ d ˈɛ n t ɪ k ə l
ideology ˌaɪ d i ˈɑ l ə d͡ʒ i
idiom ˈɪ d i ə m
ignorance ˈɪ ɡ n ɚ ə n s
immune ə m j ˈu n
imperial ɪ m p ˈɪ ɹ i ə l
implicit ɪ m p l ˈɪ s ə t
incentive ɪ n s ˈɛ n t ɪ v
inclination ˌɪ n k l ə n ˈeɪ ʃ ə n
indifferent ɪ n d ˈɪ f ɹ ə n t
inevitable ɪ n ˈɛ v ə t ə b ə l
infrastructure ˈɪ n f ɹ ə s t ɹ ˌʌ k t͡ʃ ɚ
inherent ɪ n h ˈɪ ɹ ə n t
inherit ɪ n h ˈɛ ɹ ə t
inhibit ɪ n h ˈɪ b ə t
initiative ɪ n ˈɪ ʃ ə t ɪ v
inject ɪ n d͡ʒ ˈɛ k t
injustice ɪ n d͡ʒ ˈʌ s t ə s
inland ˈɪ n l ə n d
insane ɪ n s ˈeɪ n
insight ˈɪ n s ˌaɪ t
integral ˈɪ n t ə ɡ ɹ ə l
integrate ˈɪ n t ə ɡ ɹ ˌeɪ t
integrity ɪ n t ˈɛ ɡ ɹ ə t i
intellectual ˌɪ n t ə l ˈɛ k t͡ʃ u ə l
intensity ɪ n t ˈɛ n s ə t i
interact ˌɪ n t ə ɹ ˈæ k t
interval ˈɪ n t ɚ v ə l
intervene ˌɪ n t ɚ v ˈi n
intimate ˈɪ n t ə m ə t
intricate ˈɪ n t ɹ ə k ə t
intuition ˌɪ n t u ˈɪ ʃ ə n
invasion ɪ n v ˈeɪ ʒ ə n
inventory ˈɪ n v ə n t ˌɔ ɹ i
ironic aɪ ɹ ˈɑ n ɪ k
irony ˈaɪ ɹ ə n i
irrigation ˌɪ ɹ ə ɡ ˈeɪ ʃ ə n
isolate ˈaɪ s ə l ˌeɪ t
isolation ˌaɪ s ə l ˈeɪ ʃ ə n
jurisdiction d͡ʒ ˌʊ ɹ ə s d ˈɪ k ʃ ə n
justification d͡ʒ ˌʌ s t ə f ə k ˈeɪ ʃ ə n
kidnap k ˈɪ d n ˌæ p
laser l ˈeɪ z ɚ
latitude l ˈæ t ə t ˌu d
legacy l ˈɛ ɡ ə s i
legislation l ˌɛ d͡ʒ ə s l ˈeɪ ʃ ə n
legitimate l ə d͡ʒ ˈɪ t ə m ə t
leverage l ˈɛ v ɹ ɪ d͡ʒ
liability l ˌaɪ ə b ˈɪ l ə t i
lifestyle l ˈaɪ f s t ˌaɪ l
likelihood l ˈaɪ k l i h ˌʊ d
limestone l ˈaɪ m s t ˌoʊ n
linear l ˈɪ n i ɚ
linguistic l ɪ ŋ ɡ w ˈɪ s t ɪ k
literacy l ˈɪ t ɚ ə s i
litigation l ˌɪ t ə ɡ ˈeɪ ʃ ə n
longitude l ˈɑ n d͡ʒ ə t ˌu d
lucrative l ˈu k ɹ ə t ɪ v
magnitude m ˈæ ɡ n ə t ˌu d
mainstream m ˈeɪ n s t ɹ ˌi m
mandate m ˈæ n d eɪ t
mandatory m ˈæ n d ə t ˌɔ ɹ i
maneuver m ə n ˈu v ɚ
manifest m ˈæ n ə f ˌɛ s t
manipulate m ə n ˈɪ p j ə l ˌeɪ t
manuscript m ˈæ n j ə s k ɹ ˌɪ p t
marginal m ˈɑ ɹ d͡ʒ ə n ə l
maritime m ˈɛ ɹ ə t ˌaɪ m
mathematical m ˌæ θ ə m ˈæ t ɪ k ə l
matrix m ˈeɪ t ɹ ɪ k s
mediate m ˈi d i ˌeɪ t
medieval m ˌɪ d i ˈi v ə l
meditation m ˌɛ d ə t ˈeɪ ʃ ə n
membrane m ˈɛ m b ɹ eɪ n
metabolism m ə t ˈæ b ə l ˌɪ z ə m
metaphor m ˈɛ t ə f ˌɔ ɹ
methodology m ˌɛ θ ə d ˈɑ l ə d͡ʒ i
metropolitan m ˌɛ t ɹ ə p ˈɑ l ə t ə n
migration m aɪ ɡ ɹ ˈeɪ ʃ ə n
milestone m ˈaɪ l s t ˌoʊ n
molecular m ə l ˈɛ k j ə l ɚ
molecule m ˈɑ l ə k j ˌu l
momentum m oʊ m ˈɛ n t ə m
monarchy m ˈɑ n ɚ k i
monopoly m ə n ˈɑ p ə l i
morale m ə ɹ ˈæ l
morality m ə ɹ ˈæ l ə t i
mortgage m ˈɔ ɹ ɡ ɪ d͡ʒ
motive m ˈoʊ t ɪ v
municipal m j u n ˈɪ s ə p ə l
mutation m j u t ˈeɪ ʃ ə n
mutual m j ˈu t͡ʃ u ə l
naive n aɪ ˈi v
nominate n ˈɑ m ə n ˌeɪ t
nominee n ˌɑ m ə n ˈi
nostalgia n ɑ s t ˈæ l d͡ʒ ə
notorious n oʊ t ˈɔ ɹ i ə s
nucleus n ˈu k l i ə s
nuisance n ˈu s ə n s
oblige ə b l ˈaɪ d͡ʒ
obscure ə b s k j ˈʊ ɹ
obsession ə b s ˈɛ ʃ ə n
obsolete ˌɑ b s ə l ˈi t
offset ˈɔ f s ˌɛ t
offspring ˈɔ f s p ɹ ˌɪ ŋ
omit oʊ m ˈɪ t
optimal ˈɑ p t ə m ə l
optimism ˈɑ p t ə m ˌɪ z ə m
optimize ˈɑ p t ə m ˌaɪ z
ordeal ɔ ɹ d ˈi l
organism ˈɔ ɹ ɡ ə n ˌɪ z ə m
ornament ˈɔ ɹ n ə m ə n t
orthodox ˈɔ ɹ θ ə d ˌɑ k s
outbreak ˈaʊ t b ɹ ˌeɪ k
outlook ˈaʊ t l ˌʊ k
outrage ˈaʊ t ɹ eɪ d͡ʒ
oversee ˌoʊ v ɚ s ˈi
overwhelm ˌoʊ v ɚ w ˈɛ l m
paradox p ˈɛ ɹ ə d ˌɑ k s
parameter p ə ɹ ˈæ m ə t ɚ
partial p ˈɑ ɹ ʃ ə l
participant p ɑ ɹ t ˈɪ s ə p ə n t
patent p ˈæ t ə n t
pathetic p ə θ ˈɛ t ɪ k
patron p ˈeɪ t ɹ ə n
pedestrian p ə d ˈɛ s t ɹ i ə n
penetrate p ˈɛ n ə t ɹ ˌeɪ t
peninsula p ə n ˈɪ n s ə l ə
perceive p ɚ s ˈi v
persist p ɚ s ˈɪ s t
pessimism p ˈɛ s ə m ˌɪ z ə m
pesticide p ˈɛ s t ə s ˌaɪ d
petition p ə t ˈɪ ʃ ə n
petroleum p ə t ɹ ˈoʊ l i ə m
pharmaceutical f ˌɑ ɹ m ə s ˈu t ɪ k ə l
physiology f ˌɪ z i ˈɑ l ə d͡ʒ i
pinpoint p ˈɪ n p ˌɔɪ n t
plateau p l æ t ˈoʊ
plausible p l ˈɔ z ə b ə l
pledge p l ˈɛ d͡ʒ
plural p l ˈʊ ɹ ə l
pneumonia n u m ˈoʊ n j ə
polar p ˈoʊ l ɚ
portfolio p ɔ ɹ t f ˈoʊ l i ˌoʊ
postal p ˈoʊ s t ə l
posture p ˈɑ s t͡ʃ ɚ
pragmatic p ɹ æ ɡ m ˈæ t ɪ k
precedent p ɹ ˈɛ s ə d ə n t
precision p ɹ ɪ s ˈɪ ʒ ə n
predator p ɹ ˈɛ d ə t ɚ
predecessor p ɹ ˈɛ d ə s ˌɛ s ɚ
predominantly p ɹ ɪ d ˈɑ m ə n ə n t l i
preliminary p ɹ ɪ l ˈɪ m ə n ˌɛ ɹ i
premise p ɹ ˈɛ m ə s
premium p ɹ ˈi m i ə m
prescription p ɹ ɪ s k ɹ ˈɪ p ʃ ə n
prestige p ɹ ɛ s t ˈi ʒ
presume p ɹ ɪ z ˈu m
prevail p ɹ ɪ v ˈeɪ l
privatize p ɹ ˈaɪ v ə t ˌaɪ z
probe p ɹ ˈoʊ b
proclaim p ɹ oʊ k l ˈeɪ m
productivity p ɹ ˌoʊ d ʌ k t ˈɪ v ə t i
profound p ɹ ə f ˈaʊ n d
projection p ɹ ə d͡ʒ ˈɛ k ʃ ə n
prone p ɹ ˈoʊ n
propaganda p ɹ ˌɑ p ə ɡ ˈæ n d ə
prophet p ɹ ˈɑ f ə t
prosecute p ɹ ˈɑ s ə k j ˌu t
prosperity p ɹ ɑ s p ˈɛ ɹ ə t i
protocol p ɹ ˈoʊ t ə k ˌɔ l
prototype p ɹ ˈoʊ t ə t ˌaɪ p
provoke p ɹ ə v ˈoʊ k
proximity p ɹ ɑ k s ˈɪ m ə t i
psychiatric s ˌaɪ k i ˈæ t ɹ ɪ k
publicity p ʌ b l ˈɪ s ə t i
pulse p ˈʌ l s
quota k w ˈoʊ t ə
radiation ɹ ˌeɪ d i ˈeɪ ʃ ə n
radius ɹ ˈeɪ d i ə s
rational ɹ ˈæ ʃ ə n ə l
realistic ɹ ˌi ə l ˈɪ s t ɪ k
rebellion ɹ ɪ b ˈɛ l j ə n
receptor ɹ ɪ s ˈɛ p t ɚ
recession ɹ ɪ s ˈɛ ʃ ə n
reckon ɹ ˈɛ k ə n
reconstruction ɹ ˌi k ə n s t ɹ ˈʌ k ʃ ə n
referendum ɹ ˌɛ f ə ɹ ˈɛ n d ə m
refine ɹ ɪ f ˈaɪ n
refuge ɹ ˈɛ f j u d͡ʒ
regain ɹ ɪ ɡ ˈeɪ n
regardless ɹ ɪ ɡ ˈɑ ɹ d l ə s
rehabilitation ɹ ˌi ə b ˌɪ l ə t ˈeɪ ʃ ə n
reinforce ɹ ˌi ɪ n f ˈɔ ɹ s
remainder ɹ ɪ m ˈeɪ n d ɚ
render ɹ ˈɛ n d ɚ
renowned ɹ ɪ n ˈaʊ n d
rental ɹ ˈɛ n t ə l
repetition ɹ ˌɛ p ə t ˈɪ ʃ ə n
replicate ɹ ˈɛ p l ə k ˌeɪ t
restraint ɹ ɪ s t ɹ ˈeɪ n t
retrieve ɹ ɪ t ɹ ˈi v
revelation ɹ ˌɛ v ə l ˈeɪ ʃ ə n
revival ɹ ɪ v ˈaɪ v ə l
rhetoric ɹ ˈɛ t ɚ ɪ k
rigorous ɹ ˈɪ ɡ ɚ ə s
ritual ɹ ˈɪ t͡ʃ u ə l
robust ɹ oʊ b ˈʌ s t
rotation ɹ oʊ t ˈeɪ ʃ ə n
sanction s ˈæ ŋ k ʃ ə n
sanctuary s ˈæ ŋ k t͡ʃ u ˌɛ ɹ i
sarcasm s ˈɑ ɹ k ˌæ z ə m
scrutiny s k ɹ ˈu t ə n i
seminar s ˈɛ m ə n ˌɑ ɹ
sentiment s ˈɛ n t ə m ə n t
sequel s ˈi k w ə l
simulate s ˈɪ m j ə l ˌeɪ t
simultaneous s ˌaɪ m ə l t ˈeɪ n i ə s
skeptical s k ˈɛ p t ɪ k ə l
sovereign s ˈɑ v ɹ ə n
spectacular s p ɛ k t ˈæ k j ə l ɚ
spectrum s p ˈɛ k t ɹ ə m
speculate s p ˈɛ k j ə l ˌeɪ t
spontaneous s p ɑ n t ˈeɪ n i ə s
statistical s t ə t ˈɪ s t ɪ k ə l
stereotype s t ˈɛ ɹ i ə t ˌaɪ p
stimulus s t ˈɪ m j ə l ə s
strategic s t ɹ ə t ˈi d͡ʒ ɪ k
subsequent s ˈʌ b s ə k w ə n t
subsidy s ˈʌ b s ə d i
summon s ˈʌ m ə n
supplement s ˈʌ p l ə m ə n t
suspend s ə s p ˈɛ n d
sustain s ə s t ˈeɪ n
syndrome s ˈɪ n d ɹ oʊ m
synthetic s ɪ n θ ˈɛ t ɪ k
tactic t ˈæ k t ɪ k
tariff t ˈɛ ɹ ə f
tedious t ˈi d i ə s
temporal t ˈɛ m p ɚ ə l
terminal t ˈɚ m ə n ə l
terminate t ˈɚ m ə n ˌeɪ t
terrain t ə ɹ ˈeɪ n
testify t ˈɛ s t ə f ˌaɪ
testimony t ˈɛ s t ə m ˌoʊ n i
textile t ˈɛ k s t aɪ l
theology θ i ˈɑ l ə d͡ʒ i
theoretical θ ˌi ə ɹ ˈɛ t ɪ k ə l
thermal θ ˈɚ m ə l
threshold θ ɹ ˈɛ ʃ h ˌoʊ l d
thrive θ ɹ ˈaɪ v
toll t ˈoʊ l
toxic t ˈɑ k s ɪ k
trademark t ɹ ˈeɪ d m ˌɑ ɹ k
trait t ɹ ˈeɪ t
tranquil t ɹ ˈæ ŋ k w ə l
transaction t ɹ æ n z ˈæ k ʃ ə n
transcript t ɹ ˈæ n s k ɹ ˌɪ p t
transmission t ɹ æ n z m ˈɪ ʃ ə n
transmit t ɹ æ n z m ˈɪ t
transparent t ɹ æ n s p ˈɛ ɹ ə n t
trauma t ɹ ˈɔ m ə
tribunal t ɹ aɪ b j ˈu n ə l
tribute t ɹ ˈɪ b j u t
trigger t ɹ ˈɪ ɡ ɚ
tuition t u ˈɪ ʃ ə n
turbine t ˈɚ b aɪ n
turmoil t ˈɚ m ɔɪ l
tutor t ˈu t ɚ
ultimatum ˌʌ l t ə m ˈeɪ t ə m
undermine ˌʌ n d ɚ m ˈaɪ n
undertake ˌʌ n d ɚ t ˈeɪ k
unify j ˈu n ə f ˌaɪ
unprecedented ʌ n p ɹ ˈɛ s ə d ˌɛ n t ə d
uphold ʌ p h ˈoʊ l d
utilize j ˈu t ə l ˌaɪ z
vaccine v æ k s ˈi n
validate v ˈæ l ə d ˌeɪ t
vapor v ˈeɪ p ɚ
variable v ˈɛ ɹ i ə b ə l
variation v ˌɛ ɹ i ˈeɪ ʃ ə n
velocity v ə l ˈɑ s ə t i
vendor v ˈɛ n d ɚ
verdict v ˈɚ d ɪ k t
verify v ˈɛ ɹ ə f ˌaɪ
versatile v ˈɚ s ə t ə l
veto v ˈi t oʊ
viable v ˈaɪ ə b ə l
vibrant v ˈaɪ b ɹ ə n t
vicious v ˈɪ ʃ ə s
vigorous v ˈɪ ɡ ɚ ə s
vulnerable v ˈʌ l n ɚ ə b ə l
warfare w ˈɔ ɹ f ˌɛ ɹ
warrant w ˈɔ ɹ ə n t
warranty w ˈɔ ɹ ə n t i
withdrawal w ɪ ð d ɹ ˈɔ ə l
withstand w ɪ θ s t ˈæ n d
witty w ˈɪ t i
workforce w ˈɚ k f ˌɔ ɹ s
workload w ˈɚ k l ˌoʊ d
worthwhile w ˌɚ θ w ˈaɪ l
yearn j ˈɚ n
yoga j ˈoʊ ɡ ə
zeal z ˈi l
zinc z ˈɪ ŋ k
colonel k ˈɚ n ə l
lieutenant l u t ˈɛ n ə n t
sergeant s ˈɑ ɹ d͡ʒ ə n t
yacht j ˈɑ t
choir k w ˈaɪ ɚ
chaos k ˈeɪ ɑ s
queue k j ˈu
epitome ɪ p ˈɪ t ə m i
hyperbole h aɪ p ˈɚ b ə l i
apostrophe ə p ˈɑ s t ɹ ə f i
mischievous m ˈɪ s t͡ʃ ə v ə s
pronunciation p ɹ ə n ˌʌ n s i ˈeɪ ʃ ə n
luxurious l ʌ ɡ ʒ ˈʊ ɹ i ə s
silhouette s ˌɪ l u ˈɛ t
champagne ʃ æ m p ˈeɪ n
bouquet b oʊ k ˈeɪ
renaissance ɹ ˈɛ n ə s ˌɑ n s
thorough θ ˈɚ oʊ
though ð ˈoʊ
trousers t ɹ ˈaʊ z ɚ z
pharmacy f ˈɑ ɹ m ə s i
broccoli b ɹ ˈɑ k ə l i
spinach s p ˈɪ n ɪ t͡ʃ
quantum k w ˈɑ n t ə m
submarine s ˈʌ b m ə ɹ ˌi n
archaeology ˌɑ ɹ k i ˈɑ l ə d͡ʒ i
niche n ˈɪ t͡ʃ
genre ʒ ˈɑ n ɹ ə
rendezvous ɹ ˈɑ n d eɪ v ˌu
aisle ˈaɪ ə l
heir ˈɛ ɹ
hymn h ˈɪ m
corps k ˈɔ ɹ
depot d ˈi p oʊ
buffet b ə f ˈeɪ
crochet k ɹ oʊ ʃ ˈeɪ
duvet d u v ˈeɪ
valet v æ l ˈeɪ
cafe k æ f ˈeɪ
cliche k l i ʃ ˈeɪ
sachet s æ ʃ ˈeɪ
antique æ n t ˈi k
boutique b u t ˈi k
intrigue ɪ n t ɹ ˈi ɡ
plague p l ˈeɪ ɡ
morgue m ˈɔ ɹ ɡ
catalogue k ˈæ t ə l ˌɔ ɡ
monologue m ˈɑ n ə l ˌɔ ɡ
epilogue ˈɛ p ə l ˌɔ ɡ
prologue p ɹ ˈoʊ l ɔ ɡ
synagogue s ˈɪ n ə ɡ ˌɑ ɡ
viscount v ˈaɪ k aʊ n t
indict ɪ n d ˈaɪ t
almond ˈɑ m ə n d
chassis t͡ʃ ˈæ s i
debut d eɪ b j ˈu
cello t͡ʃ ˈɛ l oʊ
chef ʃ ˈɛ f
parachute p ˈɛ ɹ ə ʃ ˌu t
brochure b ɹ oʊ ʃ ˈʊ ɹ
pistachio p ɪ s t ˈæ ʃ i ˌoʊ
fuchsia f j ˈu ʃ ə
european j ˌʊ ɹ ə p ˈi ə n
asia ˈeɪ ʒ ə
asian ˈeɪ ʒ ə n
australia ɔ s t ɹ ˈeɪ l j ə
melon m ˈɛ l ə n
awesome ˈɔ s ə m
minus m ˈaɪ n ə s
london l ˈʌ n d ə n
cinema s ˈɪ n ə m ə
boston b ˈɔ s t ə n
o'clock ə k l ˈɑ k
arrive ə ɹ ˈaɪ v
arrival ə ɹ ˈaɪ v ə l
russia ɹ ˈʌ ʃ ə
russian ɹ ˈʌ ʃ ə n
sarah s ˈɛ ɹ ə
tomato t ə m ˈeɪ t oʊ
missus m ˈɪ s ə z
cetera s ˈɛ t ɚ ə
versus v ˈɚ s ə s
synthesize s ˈɪ n θ ə s ˌaɪ z
synthesizer s ˈɪ n θ ə s ˌaɪ z ɚ
synthesis s ˈɪ n θ ə s ə s
specify s p ˈɛ s ə f ˌaɪ
specific s p ə s ˈɪ f ɪ k
python p ˈaɪ θ ɑ n
vocoder v ˈoʊ k oʊ d ɚ
phoneme f ˈoʊ n i m
interface ˈɪ n t ɚ f ˌeɪ s
software s ˈɔ f t w ˌɛ ɹ
hardware h ˈɑ ɹ d w ˌɛ ɹ
framework f ɹ ˈeɪ m w ˌɚ k
algorithm ˈæ l ɡ ə ɹ ˌɪ ð ə m
neural n ˈʊ ɹ ə l
audio ˈɔ d i oʊ
launch l ˈɔ n t͡ʃ
washington w ˈɑ ʃ ɪ ŋ t ə n
approximately ə p ɹ ˈɑ k s ə m ə t l i
approximate ə p ɹ ˈɑ k s ə m ə t
refused ɹ ɪ f j ˈu z d
refusing ɹ ɪ f j ˈu z ɪ ŋ
rebels ɹ ˈɛ b ə l z
video v ˈɪ d i oʊ
data d ˈeɪ t ə
server s ˈɚ v ɚ
database d ˈeɪ t ə b ˌeɪ s
gnome n ˈoʊ m
gnat n ˈæ t
gnaw n ˈɔ
diet d ˈaɪ ə t
dial d ˈaɪ ə l
quiet k w ˈaɪ ə t
poem p ˈoʊ ə m
poet p ˈoʊ ə t
geology d͡ʒ i ˈɑ l ə d͡ʒ i
photography f ə t ˈɑ ɡ ɹ ə f i
anatomy ə n ˈæ t ə m i
celebrity s ə l ˈɛ b ɹ ə t i
mysterious m ɪ s t ˈɪ ɹ i ə s
mystery m ˈɪ s t ɚ i
encyclopedia ɪ n s ˌaɪ k l ə p ˈi d i ə
association ə s ˌoʊ s i ˈeɪ ʃ ə n
byte b ˈaɪ t
megabyte m ˈɛ ɡ ə b ˌaɪ t
gigabyte ɡ ˈɪ ɡ ə b ˌaɪ t
kilobyte k ˈɪ l ə b ˌaɪ t
terabyte t ˈɛ ɹ ə b ˌaɪ t
hertz h ˈɚ t s
kilohertz k ˈɪ l ə h ˌɚ t s
megahertz m ˈɛ ɡ ə h ˌɚ t s
gigahertz ɡ ˈɪ ɡ ə h ˌɚ t s
fahrenheit f ˈɛ ɹ ə n h ˌaɪ t
celsius s ˈɛ l s i ə s
xylophone z ˈaɪ l ə f ˌoʊ n
xenon z ˈi n ɑ n
xerox z ˈɪ ɹ ɑ k s
xavier z ˈeɪ v i ɚ
charisma k ɚ ˈɪ z m ə
charismatic k ˌɛ ɹ ɪ z m ˈæ t ɪ k
chord k ˈɔ ɹ d
bourgeois b ʊ ɹ ʒ w ˈɑ
camouflage k ˈæ m ə f l ˌɑ ʒ
lingerie l ˌɑ n ʒ ə ɹ ˈeɪ
cue k j ˈu
meringue m ə ɹ ˈæ ŋ
jeopardy d͡ʒ ˈɛ p ɚ d i
jeopardize d͡ʒ ˈɛ p ɚ d ˌaɪ z
trough t ɹ ˈɔ f
dough d ˈoʊ
awry ə ɹ ˈaɪ
anemone ə n ˈɛ m ə n i
facade f ə s ˈɑ d
fiance f ˌi ɑ n s ˈeɪ
fiancee f ˌi ɑ n s ˈeɪ
victual v ˈɪ t ə l
quay k ˈi
ewe j ˈu
aye ˈaɪ
ricochet ɹ ˈɪ k ə ʃ ˌeɪ
womb w ˈu m
psalm s ˈɑ m
balm b ˈɑ m
embalm ɪ m b ˈɑ m
soften s ˈɔ f ə n
wrestle ɹ ˈɛ s ə l
wretched ɹ ˈɛ t͡ʃ ɪ d
benign b ɪ n ˈaɪ n
malign m ə l ˈaɪ n
whom h ˈu m
phoenix f ˈi n ɪ k s
pharaoh f ˈɛ ɹ oʊ
buffalo b ˈʌ f ə l ˌoʊ
solder s ˈɑ d ɚ
vineyard v ˈɪ n j ɚ d
asthma ˈæ z m ə
isthmus ˈɪ s m ə s
xenophobia z ˌɛ n ə f ˈoʊ b i ə
tornado t ɔ ɹ n ˈeɪ d oʊ
utah j ˈu t ˌɑ
elijah ɪ l ˈaɪ d͡ʒ ə
savannah s ə v ˈæ n ə
spa s p ˈɑ
bra b ɹ ˈɑ
actual ˈæ k t͡ʃ u ə l
actually ˈæ k t͡ʃ u ə l i
economical ˌɛ k ə n ˈɑ m ɪ k ə l
persuasion p ɚ s w ˈeɪ ʒ ə n
persuade p ɚ s w ˈeɪ d
ma'am m ˈæ m
y'all j ˈɔ l
won't w ˈoʊ n t
i'd ˈaɪ d
i'm ˈaɪ m
dealt d ˈɛ l t
dreamt d ɹ ˈɛ m t
leapt l ˈɛ p t
forgave f ɚ ɡ ˈeɪ v
forgiven f ɚ ɡ ˈɪ v ə n
forgive f ɚ ɡ ˈɪ v
stolen s t ˈoʊ l ə n
geese ɡ ˈi s
wolves w ˈʊ l v z
wolf w ˈʊ l f
thousandth θ ˈaʊ z ə n d θ
millionth m ˈɪ l j ə n θ
billionth b ˈɪ l j ə n θ
twentieth t w ˈɛ n t i ə θ
thirtieth θ ˈɚ t i ə θ
fortieth f ˈɔ ɹ t i ə θ
fiftieth f ˈɪ f t i ə θ
sixtieth s ˈɪ k s t i ə θ
seventieth s ˈɛ v ə n t i ə θ
eightieth ˈeɪ t i ə θ
ninetieth n ˈaɪ n t i ə θ
criteria k ɹ aɪ t ˈɪ ɹ i ə
criterion k ɹ aɪ t ˈɪ ɹ i ə n
phenomena f ə n ˈɑ m ə n ə
phenomenon f ə n ˈɑ m ə n ˌɑ n
analyses ə n ˈæ l ə s ˌi z
analysis ə n ˈæ l ə s ə s
crises k ɹ ˈaɪ s i z
crisis k ɹ ˈaɪ s ə s
theses θ ˈi s i z
thesis θ ˈi s ə s
indices ˈɪ n d ə s ˌi z
appendices ə p ˈɛ n d ə s ˌi z
matrices m ˈeɪ t ɹ ə s ˌi z
matrix m ˈeɪ t ɹ ɪ k s
cacti k ˈæ k t aɪ
cactus k ˈæ k t ə s
fungi f ˈʌ n d͡ʒ aɪ
fungus f ˈʌ ŋ ɡ ə s
alumni ə l ˈʌ m n aɪ
alumnus ə l ˈʌ m n ə s
formulae f ˈɔ ɹ m j ə l ˌi
algae ˈæ l d͡ʒ i
larvae l ˈɑ ɹ v i
larva l ˈɑ ɹ v ə
vertebrae v ˈɚ t ə b ɹ ˌeɪ
england ˈɪ ŋ ɡ l ə n d
britain b ɹ ˈɪ t ə n
japan d͡ʒ ə p ˈæ n
japanese d͡ʒ ˌæ p ə n ˈi z
chinese t͡ʃ aɪ n ˈi z
italy ˈɪ t ə l i
italian ɪ t ˈæ l j ə n
canada k ˈæ n ə d ə
canadian k ə n ˈeɪ d i ə n
texas t ˈɛ k s ə s
dallas d ˈæ l ə s
moscow m ˈɑ s k aʊ
tokyo t ˈoʊ k i ˌoʊ
beijing b eɪ d͡ʒ ˈɪ ŋ
chicago ʃ ɪ k ˈɑ ɡ oʊ
seattle s i ˈæ t ə l
miami m aɪ ˈæ m i
houston h j ˈu s t ə n
philadelphia f ˌɪ l ə d ˈɛ l f i ə
atlanta æ t l ˈæ n t ə
georgia d͡ʒ ˈɔ ɹ d͡ʒ ə
ohio oʊ h ˈaɪ oʊ
michigan m ˈɪ ʃ ɪ ɡ ə n
illinois ˌɪ l ə n ˈɔɪ
oregon ˈɔ ɹ ɪ ɡ ə n
arizona ˌɛ ɹ ɪ z ˈoʊ n ə
montana m ɑ n t ˈæ n ə
nevada n ə v ˈæ d ə
colorado k ˌɑ l ə ɹ ˈæ d oʊ
jesus d͡ʒ ˈi z ə s
muhammad m oʊ h ˈɑ m ə d
buddha b ˈʊ d ə
shakespeare ʃ ˈeɪ k s p ɪ ɹ
einstein ˈaɪ n s t aɪ n
beethoven b ˈeɪ t oʊ v ə n
mozart m ˈoʊ t s ɑ ɹ t
oxford ˈɑ k s f ɚ d
stanford s t ˈæ n f ɚ d
harvard h ˈɑ ɹ v ɚ d
princeton p ɹ ˈɪ n s t ə n
thames t ˈɛ m z
mississippi m ˌɪ s ə s ˈɪ p i
danube d ˈæ n j u b
mediterranean m ˌɛ d ə t ɚ ˈeɪ n i ə n
caribbean k ˌɛ ɹ ə b ˈi ə n
pacific p ə s ˈɪ f ɪ k
himalayas h ˌɪ m ə l ˈeɪ ə z
spotify s p ˈɑ t ɪ f ˌaɪ
iphone ˈaɪ f ˌoʊ n
wifi w ˈaɪ f ˌaɪ
login l ˈɔ ɡ ɪ n
javascript d͡ʒ ˈɑ v ə s k ɹ ˌɪ p t
selfie s ˈɛ l f i
emoji ɪ m ˈoʊ d͡ʒ i
cyber s ˈaɪ b ɚ
virtual v ˈɚ t͡ʃ u ə l
virtually v ˈɚ t͡ʃ u ə l i
sonar s ˈoʊ n ɑ ɹ
hybrid h ˈaɪ b ɹ ɪ d
enzyme ˈɛ n z aɪ m
caffeine k æ f ˈi n
nicotine n ˈɪ k ə t ˌi n
upload ˈʌ p l ˌoʊ d
pixel p ˈɪ k s ə l
crooked k ɹ ˈʊ k ɪ d
ragged ɹ ˈæ ɡ ɪ d
rugged ɹ ˈʌ ɡ ɪ d
jagged d͡ʒ ˈæ ɡ ɪ d
dogged d ˈɔ ɡ ɪ d
beloved b ɪ l ˈʌ v ɪ d
kindred k ˈɪ n d ɹ ɪ d
alleged ə l ˈɛ d͡ʒ d
allegedly ə l ˈɛ d͡ʒ ɪ d l i
allege ə l ˈɛ d͡ʒ
bough b ˈaʊ
plough p l ˈaʊ
drought d ɹ ˈaʊ t
hiccough h ˈɪ k ʌ p
slough s l ˈʌ f
numb n ˈʌ m
solemn s ˈɑ l ə m
crumb k ɹ ˈʌ m
jamb d͡ʒ ˈæ m
succumb s ə k ˈʌ m
aplomb ə p l ˈɑ m
wow w ˈaʊ
hey h ˈeɪ
ah ˈɑ
aha ɑ h ˈɑ
yeah j ˈæ
hmm h ˈʌ m
hurrah h ʊ ɹ ˈɑ
hooray h ʊ ɹ ˈeɪ
alas ə l ˈæ s
draught d ɹ ˈæ f t
redo ɹ i d ˈu
redid ɹ i d ˈɪ d
redone ɹ i d ˈʌ n
ok ˈoʊ k ˈeɪ
wanna w ˈɑ n ə
ram ɹ ˈæ m
rom ɹ ˈɑ m
gif ɡ ˈɪ f
json d͡ʒ ˈeɪ s ˌɑ n
terrace t ˈɛ ɹ ə s
transfer t ɹ ˈæ n s f ɚ
deter d ɪ t ˈɚ
confer k ə n f ˈɚ
blur b l ˈɚ
equip ɪ k w ˈɪ p
herring h ˈɛ ɹ ɪ ŋ
"""

LEXICON: typing.Dict[str, typing.List[str]] = {}
for _line in _LEXICON_RAW.strip().splitlines():
    _parts = _line.split()
    LEXICON[_parts[0]] = _parts[1:]


_SIBILANTS = {"s", "z", "ʃ", "ʒ", "t͡ʃ", "d͡ʒ"}
_VOICELESS = {"p", "t", "k", "f", "θ", "s", "ʃ", "t͡ʃ", "h"}


def _plural_phones(stem: typing.List[str]) -> typing.List[str]:
    if not stem:
        return []
    last = stem[-1].lstrip("ˈˌ")
    if last in _SIBILANTS:
        return stem + ["ə", "z"]
    if last in _VOICELESS:
        return stem + ["s"]
    return stem + ["z"]


def _past_phones(stem: typing.List[str]) -> typing.List[str]:
    if not stem:
        return []
    last = stem[-1].lstrip("ˈˌ")
    if last in {"t", "d"}:
        return stem + ["ə", "d"]
    if last in _VOICELESS:
        return stem + ["t"]
    return stem + ["d"]


def _derive_inflections() -> None:
    """Expand the hand-authored roots with regular inflected forms.

    gruut's en-us lexicon carried the inflections as first-class entries;
    deriving them at import (roots stay the authored source of truth)
    gives the same exact-match coverage without hand-writing ~5 spelling
    variants per root.  Hand entries always win — irregulars (ran, wrote,
    feet, …) are authored directly and never overwritten.  Over-generated
    keys for words that do not inflect ("thes") are unreachable in real
    text and cost only memory.
    """
    derived: typing.Dict[str, typing.List[str]] = {}
    for word, phones in LEXICON.items():
        if not word.isalpha() or len(word) < 2:
            continue
        last = phones[-1].lstrip("ˈˌ")

        # plural / 3rd-person -s (+es after sibilant spellings, y->ies)
        if word.endswith(("s", "sh", "ch", "x", "z")):
            derived.setdefault(word + "es", _plural_phones(phones))
        elif word.endswith("y") and len(word) > 2 and word[-2] not in "aeiou":
            derived.setdefault(word[:-1] + "ies", _plural_phones(phones))
        else:
            derived.setdefault(word + "s", _plural_phones(phones))
            if word.endswith("o"):
                # o-final nouns also spell the plural -oes (potatoes,
                # tomatoes, heroes) — same phonemes as -os
                derived.setdefault(word + "es", _plural_phones(phones))

        # past -ed (e + d, y -> ied, else + ed)
        if word.endswith("e"):
            derived.setdefault(word + "d", _past_phones(phones))
        elif word.endswith("y") and len(word) > 2 and word[-2] not in "aeiou":
            derived.setdefault(word[:-1] + "ied", _past_phones(phones))
        else:
            derived.setdefault(word + "ed", _past_phones(phones))

        # progressive -ing (drop silent e)
        ing_stem = word[:-1] if word.endswith("e") and last != "i" else word
        derived.setdefault(ing_stem + "ing", phones + ["ɪ", "ŋ"])

        # agentive/comparative -er (schwa-r; drop silent e)
        derived.setdefault(ing_stem + "er", phones + ["ɚ"])
        # superlative -est
        derived.setdefault(ing_stem + "est", phones + ["ə", "s", "t"])

        # consonant+y adjectives spell comparatives/nominalizations with
        # i (happy -> happier/happiest/happiness, lazy -> laziness); the
        # final [i] stays and the suffix attaches after it
        if (
            word.endswith("y")
            and len(word) > 2
            and word[-2] not in "aeiou"
            and last == "i"
        ):
            derived.setdefault(word[:-1] + "ier", phones + ["ɚ"])
            derived.setdefault(word[:-1] + "iest", phones + ["ə", "s", "t"])
            derived.setdefault(word[:-1] + "iness", phones + ["n", "ə", "s"])

        # CVC words double the final consonant before vowel-initial
        # suffixes (stop -> stopped/stopping, prefer -> preferred,
        # transfer -> transferred, big -> bigger/biggest): derive the
        # doubled spellings with the same stem phones
        if (
            len(word) >= 3
            and word[-1] in "bdfglmnprstz"
            and word[-2] in "aeiou"
            and word[-3] not in "aeiou"
        ):
            dbl = word + word[-1]
            derived.setdefault(dbl + "ed", _past_phones(phones))
            derived.setdefault(dbl + "ing", phones + ["ɪ", "ŋ"])
            derived.setdefault(dbl + "er", phones + ["ɚ"])
            derived.setdefault(dbl + "est", phones + ["ə", "s", "t"])

        # adverbial -ly
        if not word.endswith("ly"):
            derived.setdefault(word + "ly", phones + ["l", "i"])

        # -y nouns take -ist with the same stress (biology -> biologist,
        # economy -> economist)
        if word.endswith("y") and len(word) > 4 and phones[-1] == "i":
            derived.setdefault(
                word[:-1] + "ist", phones[:-1] + ["ɪ", "s", "t"]
            )
            derived.setdefault(
                word[:-1] + "ists", phones[:-1] + ["ɪ", "s", "t", "s"]
            )

    for key, phones in derived.items():
        if key not in LEXICON:
            LEXICON[key] = phones


_derive_inflections()


# -----------------------------------------------------------------------------
# Letter-to-sound rules for OOV words.  Ordered longest-match rules over the
# lowercase spelling; crude but keeps every word speakable.

_RULES: typing.List[typing.Tuple[str, str]] = [
    # multi-letter graphemes first
    ("tion", "ʃ ə n"),
    ("sion", "ʒ ə n"),
    ("ought", "ˈɔ t"),
    ("aught", "ˈɔ t"),
    ("eigh", "ˈeɪ"),
    ("igh", "ˈaɪ"),
    ("tch", "t͡ʃ"),
    ("dge", "d͡ʒ"),
    ("sch", "s k"),
    ("ing", "ɪ ŋ"),
    ("qu", "k w"),
    ("th", "θ"),
    ("sh", "ʃ"),
    ("ch", "t͡ʃ"),
    ("ph", "f"),
    ("wh", "w"),
    ("ck", "k"),
    ("ng", "ŋ"),
    ("gh", "ɡ"),
    ("wr", "ɹ"),
    ("kn", "n"),
    ("oo", "ˈu"),
    ("ee", "ˈi"),
    ("ea", "ˈi"),
    ("ai", "ˈeɪ"),
    ("ay", "ˈeɪ"),
    ("oa", "ˈoʊ"),
    ("ow", "ˈoʊ"),
    ("ou", "ˈaʊ"),
    ("oi", "ˈɔɪ"),
    ("oy", "ˈɔɪ"),
    ("au", "ˈɔ"),
    ("aw", "ˈɔ"),
    ("ew", "ˈu"),
    ("ey", "ˈi"),
    ("ie", "ˈi"),
    ("ue", "ˈu"),
    ("ar", "ˈɑ ɹ"),
    ("er", "ɚ"),
    ("ir", "ˈɚ"),
    ("or", "ˈɔ ɹ"),
    ("ur", "ˈɚ"),
    # single letters
    ("a", "æ"),
    ("b", "b"),
    ("c", "k"),
    ("d", "d"),
    ("e", "ɛ"),
    ("f", "f"),
    ("g", "ɡ"),
    ("h", "h"),
    ("i", "ɪ"),
    ("j", "d͡ʒ"),
    ("k", "k"),
    ("l", "l"),
    ("m", "m"),
    ("n", "n"),
    ("o", "ɑ"),
    ("p", "p"),
    ("r", "ɹ"),
    ("s", "s"),
    ("t", "t"),
    ("u", "ʌ"),
    ("v", "v"),
    ("w", "w"),
    ("x", "k s"),
    ("y", "i"),
    ("z", "z"),
]

_VOWEL_SYMBOLS = {
    "aɪ", "aʊ", "eɪ", "i", "oʊ", "u", "æ", "ɑ", "ɔ", "ɔɪ", "ə", "ɚ", "ɛ",
    "ɪ", "ʊ", "ʌ",
}

# letters that should be spelled out (acronyms, single letters)
_LETTER_NAMES = {
    "a": ["ˈeɪ"], "b": ["b", "ˈi"], "c": ["s", "ˈi"], "d": ["d", "ˈi"],
    "e": ["ˈi"], "f": ["ˈɛ", "f"], "g": ["d͡ʒ", "ˈi"], "h": ["ˈeɪ", "t͡ʃ"],
    "i": ["ˈaɪ"], "j": ["d͡ʒ", "ˈeɪ"], "k": ["k", "ˈeɪ"], "l": ["ˈɛ", "l"],
    "m": ["ˈɛ", "m"], "n": ["ˈɛ", "n"], "o": ["ˈoʊ"], "p": ["p", "ˈi"],
    "q": ["k", "j", "ˈu"], "r": ["ˈɑ", "ɹ"], "s": ["ˈɛ", "s"],
    "t": ["t", "ˈi"], "u": ["j", "ˈu"], "v": ["v", "ˈi"],
    "w": ["d", "ˈʌ", "b", "ə", "l", "j", "u"], "x": ["ˈɛ", "k", "s"],
    "y": ["w", "ˈaɪ"], "z": ["z", "ˈi"],
}


_CONSONANT_LETTERS = set("bcdfghjklmnpqrstvwxz")


def _collapse_geminates(body: str) -> str:
    """English has no geminate consonants: doubled letters are one sound
    (sunny, swimming, berry).  ``cc`` before a softening vowel is the
    [ks] cluster (accent, success) and is respelled ``cs`` so the scan
    softens the second half."""
    out: typing.List[str] = []
    i = 0
    while i < len(body):
        ch = body[i]
        if (
            ch in _CONSONANT_LETTERS
            and i + 1 < len(body)
            and body[i + 1] == ch
        ):
            nxt = body[i + 2] if i + 2 < len(body) else ""
            if ch == "c" and nxt in "eiy":
                out.append("cs")
            else:
                out.append(ch)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _apply_rules(word: str) -> typing.List[str]:
    out: typing.List[str] = []
    i = 0
    n = len(word)
    # final silent e ("make", "time") with magic-e vowel lengthening
    magic_e = bool(re.search(r"[bcdfgklmnprstvz]e$", word)) and n > 3
    # word-initial silent-letter clusters (pneumatic, psychic, gnarl,
    # pterodactyl, mnemonic; kn-/wr- mostly live in the lexicon but OOV
    # coinages still need them)
    for cluster, sound in (
        ("pn", "n"), ("ps", "s"), ("pt", "t"), ("gn", "n"),
        ("kn", "n"), ("mn", "n"), ("wr", "r"),
    ):
        if word.startswith(cluster) and n > 3 and any(
            c in "aeiouy" for c in word[2:]
        ):
            word = sound + word[2:]
            n = len(word)
            break
    # word-initial x is [z] (xylophone, xenon, xerox) — never [ks]
    if word.startswith("x") and n > 1:
        word = "z" + word[1:]
    # word-final silent clusters: -mb drops the b (crumb, succumb,
    # aplomb), -mn drops the n (solemn, autumn) — only at the word end;
    # medial clusters keep both (number, amnesty, columnist)
    if n > 3 and (word.endswith("mb") or word.endswith("mn")):
        word = word[:-1]
        n = len(word)
    body = _collapse_geminates(word[:-1] if magic_e else word)
    if magic_e:
        body_vowels = {"a": "ˈeɪ", "i": "ˈaɪ", "o": "ˈoʊ", "u": "ˈu", "e": "ˈi"}
    while i < len(body):
        ch = body[i]
        # the letter after this one; a magic-e word keeps its silent e as
        # softening context for the final consonant (office, cage)
        nxt = body[i + 1] if i + 1 < len(body) else ("e" if magic_e else "")
        # soft c/g before e, i, y (celebrate, city, gentle, energy); the
        # digraphs ch/ck/gh keep their own rules
        # NB: nxt may be "" at word end — and '' is "in" every string, so
        # every membership test below must guard on nxt being non-empty
        if (
            ch == "c"
            and nxt
            and nxt in "eiy"
            and not body.startswith(("ch", "ck"), i)
        ):
            out.append("s")
            i += 1
            continue
        if ch == "g" and nxt and nxt in "eiy" and not body.startswith("gh", i):
            out.append("d͡ʒ")
            i += 1
            continue
        # Greek ch before a consonant is [k] (technical, chrome, chlorine)
        if (
            body.startswith("ch", i)
            and body[i + 2 : i + 3] in _CONSONANT_LETTERS
        ):
            out.append("k")
            i += 2
            continue
        # y: glide before a vowel (yard), happy-vowel [i] word-finally,
        # lax [ɪ] inside a syllable (system)
        if ch == "y":
            if nxt and nxt in "aeiou":
                out.append("j")
            else:
                out.append("i" if i == len(body) - 1 else "ɪ")
            i += 1
            continue
        # word-final vowel-letter phonology (the default single-letter
        # rules below describe CLOSED syllables): final unstressed -a is
        # schwa (sofa, data, charisma — never [æ]), final -ah likewise
        # with a silent h (sarah, hannah), final -o says its name
        # (buffalo, piano, zero — never [ɑ]), and a final h after any
        # vowel is mute (pharaoh, hurrah)
        if ch == "a" and len(body) >= 4 and i == len(body) - 2 and body[i:] == "ah":
            out.append("ə")
            i += 2
            continue
        if ch == "a" and i == len(body) - 1 and len(body) >= 4:
            out.append("ə")
            i += 1
            continue
        if ch == "o" and i == len(body) - 1 and len(body) >= 3:
            out.append("oʊ")
            i += 1
            continue
        if (
            ch == "h"
            and i == len(body) - 1
            and out
            and out[-1].lstrip("ˈˌ") in _VOWEL_SYMBOLS
        ):
            i += 1
            continue
        # "er" early in the word before a vowel is a checked [ɛ] + onset
        # r (merit, sheriff, peril, herald; ferry/errand arrive here via
        # geminate collapse) — not the ɚ of "er"+consonant.  "over-"
        # compounds keep ɚ (overall, overeat).
        if (
            body.startswith("er", i)
            and i <= 2
            and i + 2 < len(body)
            and body[i + 2] in "aeiouy"
            and not body.startswith("ov")
        ):
            out.extend(["ɛ", "ɹ"])
            i += 2
            continue
        for pattern, phones in _RULES:
            if body.startswith(pattern, i):
                # magic-e: the last single vowel before final consonant says
                # its name
                if (
                    magic_e
                    and pattern in ("a", "e", "i", "o", "u")
                    and i >= len(body) - 2
                ):
                    out.extend(body_vowels[pattern].split())
                else:
                    out.extend(phones.split())
                i += len(pattern)
                break
        else:
            i += 1  # unknown character: skip
    # residual identical-consonant clusters from morpheme seams
    deduped: typing.List[str] = []
    for p in out:
        if deduped and p == deduped[-1] and p.lstrip("ˈˌ") not in _VOWEL_SYMBOLS:
            continue
        deduped.append(p)
    return deduped


# Suffixes with predictable primary-stress position, counted in syllables
# from the END of the word (1 = last syllable, 2 = penult, 3 = antepenult).
# Standard English stress phonology; gruut resolved these via its lexicon.
_SUFFIX_STRESS: typing.Tuple[typing.Tuple[str, int], ...] = (
    # stress falls ON the suffix
    ("ee", 1), ("eer", 1), ("ese", 1), ("esque", 1), ("ette", 1),
    ("ique", 1), ("oon", 1), ("ain", 1),
    # stress on the syllable immediately before the suffix
    ("tion", 2), ("sion", 2), ("cian", 2), ("tious", 2), ("cious", 2),
    ("ic", 2), ("ical", 3), ("ically", 4), ("ity", 3), ("ety", 3),
    ("ify", 3), ("itive", 3), ("itude", 3), ("graphy", 3), ("logy", 3),
    ("gamy", 3), ("cracy", 3), ("meter", 3), ("pathy", 3),
)


def _vowel_indices(phonemes: typing.Sequence[str]) -> typing.List[int]:
    return [
        i
        for i, p in enumerate(phonemes)
        if p.lstrip("ˈˌ") in _VOWEL_SYMBOLS
    ]


def _ensure_stress(
    phonemes: typing.List[str], word: str = ""
) -> typing.List[str]:
    """Assign primary stress to rule-derived pronunciations.

    Suffix phonology picks the syllable when it can; otherwise the first
    vowel carries stress (the common English noun/adjective pattern).
    Words of 4+ syllables with late primary stress also get an initial
    secondary stress.
    """
    out = list(phonemes)
    vowels = _vowel_indices(out)
    if not vowels:
        return out

    suffix_target = None
    for suffix, from_end in _SUFFIX_STRESS:
        if (
            word.endswith(suffix)
            and len(word) > len(suffix) + 2
            and from_end <= len(vowels)
        ):
            suffix_target = len(vowels) - from_end
            break

    # one primary stress per word: the rule table pre-stresses every
    # long vowel/digraph, so a word like "railway" comes in with two ˈ
    # marks — keep the first (the default English noun pattern) and
    # demote the rest to secondary
    primaries = [i for i, p in enumerate(out) if p.startswith("ˈ")]
    for j in primaries[1:]:
        out[j] = "ˌ" + out[j][1:]

    has_stress = any(p.startswith(("ˈ", "ˌ")) for p in out)
    if suffix_target is None:
        if has_stress:
            return out
        target = 0
    else:
        # the rule table pre-stresses some long vowels; suffix phonology
        # overrides it
        out = [
            p.lstrip("ˈˌ") if p.lstrip("ˈˌ") in _VOWEL_SYMBOLS else p
            for p in out
        ]
        vowels = _vowel_indices(out)
        target = suffix_target
    out[vowels[target]] = "ˈ" + out[vowels[target]]
    if target >= 2 and len(vowels) >= 4:
        out[vowels[0]] = "ˌ" + out[vowels[0]]
    return out


# Word-final suffixes whose phonology the letter rules cannot derive
# (tion/sion already live in _RULES; these need word-final context so
# "ous" does not eat "house").  Entry: (spelling, phones, min prefix
# letters).  A ˈ in the phones claims the word's primary stress.
_FINAL_SUFFIX_PHONES: typing.Tuple[typing.Tuple[str, str, int], ...] = (
    ("ciation", "s i ˈeɪ ʃ ə n", 3),
    ("tiation", "ʃ i ˈeɪ ʃ ə n", 3),
    ("ization", "ə z ˈeɪ ʃ ə n", 3),
    ("isation", "ə z ˈeɪ ʃ ə n", 3),
    ("ation", "ˈeɪ ʃ ə n", 2),
    ("ician", "ˈɪ ʃ ə n", 2),
    ("itious", "ˈɪ ʃ ə s", 2),
    ("itial", "ˈɪ ʃ ə l", 2),
    ("cious", "ʃ ə s", 3),
    ("tious", "ʃ ə s", 3),
    ("geous", "d͡ʒ ə s", 3),
    ("gious", "d͡ʒ ə s", 3),
    ("cian", "ʃ ə n", 3),
    ("cial", "ʃ ə l", 3),
    ("tial", "ʃ ə l", 3),
    ("ture", "t͡ʃ ɚ", 3),
    ("sure", "ʒ ɚ", 3),
    ("ough", "oʊ", 3),
    ("ous", "ə s", 3),
    ("ive", "ɪ v", 3),
    ("age", "ɪ d͡ʒ", 3),
    ("escence", "ˈɛ s ə n s", 3),
    ("escent", "ˈɛ s ə n t", 3),
    ("ism", "ˌɪ z ə m", 3),
    ("tech", "t ˌɛ k", 3),
    ("fy", "f ˌaɪ", 3),
    ("le", "ə l", 2),
)

# Stress-neutral suffixes: attach to the stem's pronunciation unchanged.
_NEUTRAL_SUFFIXES: typing.Tuple[typing.Tuple[str, str], ...] = (
    ("ness", "n ə s"),
    ("less", "l ə s"),
    ("ment", "m ə n t"),
    ("ship", "ʃ ˌɪ p"),
    ("hood", "h ˌʊ d"),
    ("ful", "f ə l"),
)

# Stress-neutral prefixes: the stem keeps its primary stress, the prefix
# gets at most a secondary (unbreakable, misjudge).  Only fires when the
# remainder resolves through the lexicon, so "mister" can never split as
# mis+ter.
_NEUTRAL_PREFIXES: typing.Tuple[typing.Tuple[str, str], ...] = (
    ("electro", "ɪ l ˌɛ k t ɹ oʊ"),
    ("thermo", "θ ˌɚ m oʊ"),
    ("crypto", "k ɹ ˌɪ p t oʊ"),
    ("under", "ˌʌ n d ɚ"),
    ("inter", "ˌɪ n t ɚ"),
    ("super", "s ˌu p ɚ"),
    ("multi", "m ˌʌ l t i"),
    ("hyper", "h ˌaɪ p ɚ"),
    ("cyber", "s ˌaɪ b ɚ"),
    ("micro", "m ˌaɪ k ɹ oʊ"),
    ("macro", "m ˌæ k ɹ oʊ"),
    ("psycho", "s ˌaɪ k oʊ"),
    ("hypo", "h ˌaɪ p oʊ"),
    ("auto", "ˌɔ t oʊ"),
    ("nano", "n ˌæ n oʊ"),
    ("bio", "b ˌaɪ oʊ"),
    ("over", "ˌoʊ v ɚ"),
    ("anti", "ˌæ n t i"),
    ("semi", "s ˌɛ m i"),
    ("non", "n ˌɑ n"),
    ("mis", "m ˌɪ s"),
    ("dis", "d ˌɪ s"),
    ("out", "ˌaʊ t"),
    ("un", "ˌʌ n"),
    ("re", "ɹ i"),
    ("pre", "p ɹ i"),
)


def _has_vowel_letter(s: str) -> bool:
    return any(c in "aeiouy" for c in s)


def _demote_primary(phones: typing.Sequence[str]) -> typing.List[str]:
    return [("ˌ" + p[1:]) if p.startswith("ˈ") else p for p in phones]


def _cvc_final(stem: str) -> bool:
    """Final consonant after a single vowel letter (shin, nat): the
    spelling pattern that signals a dropped silent e in derivation."""
    return (
        len(stem) >= 3
        and stem[-1] in _CONSONANT_LETTERS
        and stem[-2] in "aeiou"
        and stem[-3] in _CONSONANT_LETTERS
    )


def _compound_split(w: str) -> typing.Optional[typing.List[str]]:
    """Two-lexicon-word compounds (watermelon, passport): first part
    keeps primary stress, second demotes to secondary.  Both halves
    must be real entries and the word long enough (>= 7 letters) that a
    coincidental split (sea+son) cannot fire."""
    if len(w) < 7:
        return None
    best = None
    for k in range(3, len(w) - 2):
        a, b = w[:k], w[k:]
        if a in LEXICON and b in LEXICON:
            score = min(k, len(w) - k)
            if best is None or score > best[0]:
                best = (score, a, b)
    if best is None:
        return None
    _, a, b = best
    return list(LEXICON[a]) + _demote_primary(LEXICON[b])


def _oov_phonemize(w: str, depth: int = 0) -> typing.List[str]:
    """OOV pipeline: strip inflection/derivation down to known stems,
    apply word-final suffix phonology, try compound splitting, and only
    then fall back to the raw letter-to-sound rules."""

    def inner(stem: str) -> typing.List[str]:
        if stem in LEXICON:
            return list(LEXICON[stem])
        if depth >= 2:
            return _ensure_stress(_apply_rules(stem), stem)
        return _oov_phonemize(stem, depth + 1)

    # contractions: base word + clitic ('re 've 'll 'd 's n't).  The
    # frozen forms (don't, won't, can't, i've, it's, …) are lexicon
    # entries and never reach here.
    if "'" in w and len(w) >= 4:
        if w.endswith("n't"):
            base = inner(w[:-3])
            last = base[-1].lstrip("ˈˌ") if base else ""
            if last in _VOWEL_SYMBOLS or last == "ɹ":
                return base + ["n", "t"]
            return base + ["ə", "n", "t"]
        for sfx, tail in (("'re", ["ɹ"]), ("'ve", ["v"]), ("'d", ["d"])):
            if w.endswith(sfx):
                return inner(w[: -len(sfx)]) + tail
        if w.endswith("'ll"):
            base = inner(w[:-3])
            last = base[-1].lstrip("ˈˌ") if base else ""
            if last in {"t", "d"}:
                return base + ["ə", "l"]
            return base + ["l"]
        if w.endswith("'s"):
            return _plural_phones(inner(w[:-2]))

    # -ies/-ied ride the -y stem (berries, carried)
    if w.endswith("ies") and len(w) >= 5:
        return inner(w[:-3] + "y") + ["z"]
    if w.endswith("ied") and len(w) >= 5:
        return inner(w[:-3] + "y") + ["d"]

    # -ize verb family: always [aɪ z] (weaponized, gamifying aside);
    # letter rules would read the i short before the inflection
    for sfx, tail in (
        ("izing", ["ˌaɪ", "z", "ɪ", "ŋ"]),
        ("ized", ["ˌaɪ", "z", "d"]),
        ("izer", ["ˌaɪ", "z", "ɚ"]),
        ("ize", ["ˌaɪ", "z"]),
    ):
        if w.endswith(sfx) and len(w) >= len(sfx) + 3 and _has_vowel_letter(
            w[: -len(sfx)]
        ):
            return inner(w[: -len(sfx)]) + tail

    # -ically adverbs: the -al is silent in speech (basically
    # [ˈbeɪsɪkli]) — ride the -ic adjective
    if w.endswith("ically") and len(w) >= 9:
        return inner(w[:-4]) + ["l", "i"]

    # regular plural / 3rd-person -s with correct voicing (trousers,
    # handbooks); -ss/-us/... finals are lexical s, not inflection
    if (
        len(w) >= 5
        and w.endswith("s")
        and not w.endswith(("ss", "us", "is", "os", "as", "ys"))
    ):
        if w.endswith(("shes", "ches", "xes", "zes", "ses")):
            return inner(w[:-2]) + ["ə", "z"]
        return _plural_phones(inner(w[:-1]))

    for suffix, phones in _NEUTRAL_SUFFIXES:
        stem = w[: -len(suffix)]
        if w.endswith(suffix) and len(stem) >= 3 and _has_vowel_letter(stem):
            return inner(stem) + phones.split()

    # -ily adverbs keep the -y adjective's stem (happy -> happily)
    if w.endswith("ily") and w[:-3] + "y" in LEXICON:
        stem_ph = list(LEXICON[w[:-3] + "y"])
        if stem_ph and stem_ph[-1] == "i":
            stem_ph = stem_ph[:-1] + ["ə"]
        return stem_ph + ["l", "i"]
    if w.endswith("ly") and len(w) >= 5 and _has_vowel_letter(w[:-2]):
        return inner(w[:-2]) + ["l", "i"]

    # -y adjectives: rainy, sunny (doubled stem), noisy/shiny (dropped e)
    if w.endswith("y") and len(w) >= 5:
        stem = w[:-1]
        if _cvc_final(stem) and stem + "e" in LEXICON:
            return list(LEXICON[stem + "e"]) + ["i"]
        if stem in LEXICON:
            return list(LEXICON[stem]) + ["i"]
        if len(stem) >= 3 and stem[-1] == stem[-2] and stem[:-1] in LEXICON:
            return list(LEXICON[stem[:-1]]) + ["i"]
        if stem + "e" in LEXICON:
            return list(LEXICON[stem + "e"]) + ["i"]

    # -able/-ible: stress-neutral, with dropped-e / doubled-consonant
    # stem recovery (believable, forgettable)
    for able in ("able", "ible"):
        if not w.endswith(able) or len(w) < len(able) + 3:
            continue
        stem = w[: -len(able)]
        if stem in LEXICON:
            cand = list(LEXICON[stem])
        elif stem + "e" in LEXICON:
            cand = list(LEXICON[stem + "e"])
        elif len(stem) >= 3 and stem[-1] == stem[-2] and depth < 2:
            # collapse the doubling before recursing so a prefixed stem
            # (unforgett-) still finds its root (un+forget)
            cand = (
                list(LEXICON[stem[:-1]])
                if stem[:-1] in LEXICON
                else _oov_phonemize(stem[:-1], depth + 1)
            )
        elif _has_vowel_letter(stem) and depth < 2:
            cand = _oov_phonemize(stem, depth + 1)
        else:
            continue
        return cand + ["ə", "b", "ə", "l"]

    # doubled-consonant / dropped-e inflection stems the derivation
    # tables missed (swimming, stopped, runner)
    for suffix, tail in (
        ("ing", ["ɪ", "ŋ"]),
        ("ed", None),
        ("er", ["ɚ"]),
        ("est", ["ə", "s", "t"]),
    ):
        if not w.endswith(suffix) or len(w) < len(suffix) + 3:
            continue
        stem = w[: -len(suffix)]
        cand = None
        if len(stem) >= 3 and stem[-1] == stem[-2] and stem[:-1] in LEXICON:
            cand = list(LEXICON[stem[:-1]])
        elif _cvc_final(stem) and stem + "e" in LEXICON:
            cand = list(LEXICON[stem + "e"])
        if cand is not None:
            return _past_phones(cand) if tail is None else cand + tail

    # stress-neutral prefixes (unbreakable, misjudged, rewritten): the
    # remainder must be a lexicon word, or long enough that its own OOV
    # resolution beats letter rules on the unsplit word
    for prefix, pphones in _NEUTRAL_PREFIXES:
        if not w.startswith(prefix):
            continue
        rest = w[len(prefix):]
        if len(rest) < 3 or not _has_vowel_letter(rest):
            continue
        if rest in LEXICON:
            rest_ph = list(LEXICON[rest])
        elif len(rest) >= 5 and depth < 2:
            rest_ph = _oov_phonemize(rest, depth + 1)
        else:
            continue
        return _ensure_stress(pphones.split() + rest_ph)

    for suffix, phones, min_prefix in _FINAL_SUFFIX_PHONES:
        prefix = w[: -len(suffix)]
        if (
            not w.endswith(suffix)
            or len(prefix) < min_prefix
            or not _has_vowel_letter(prefix)
        ):
            continue
        # consonant+le only (little, handle) — vowel+le is magic-e (mile)
        if suffix == "le" and prefix[-1] not in _CONSONANT_LETTERS:
            continue
        # a 2-3 letter vowel-final lexicon word (spa, bra) is a false
        # stem here — "spacious" is spa-cious the open syllable, not
        # spa+cious the compound — so the name-saying branch wins
        if prefix in LEXICON and not (
            prefix[-1] in "aeiou" and len(prefix) <= 3
        ):
            prefix_ph = list(LEXICON[prefix])
        elif prefix[-1] in "aeiou" and len(prefix) >= 2:
            # a prefix-final vowel sits in an open syllable before the
            # suffix and says its name (spa-cious, cre-ation)
            long_v = {
                "a": "ˈeɪ", "e": "ˈi", "i": "ˈaɪ", "o": "ˈoʊ", "u": "ˈu",
            }[prefix[-1]]
            prefix_ph = _apply_rules(prefix[:-1]) + long_v.split()
        else:
            prefix_ph = _apply_rules(prefix)
        suffix_ph = phones.split()
        if any(p.startswith("ˈ") for p in suffix_ph):
            return _demote_primary(prefix_ph) + suffix_ph
        return _ensure_stress(prefix_ph + suffix_ph)


    split = _compound_split(w)
    if split is not None:
        return _ensure_stress(split)

    # late fallback for regular OOV past tense: resolve the stem and
    # voice the -ed (gnarled [nɑɹld]) — the letter rules would read a
    # full [ɛ d].  After prefixes/compounds so mis+pronounced keeps its
    # stem-aware path; -red nouns (hatred) stay lexical.
    if (
        w.endswith("ed")
        and len(w) >= 6
        and not w.endswith(("eed", "ied", "red"))
        and _has_vowel_letter(w[:-2])
        and depth < 2
    ):
        return _past_phones(_oov_phonemize(w[:-2], depth + 1))

    return _ensure_stress(_apply_rules(w), w)


# Common noun/verb homographs: (noun-or-adjective, verb) pronunciations.
# gruut disambiguated with a POS model; here a light context heuristic
# (see phonemize) picks the reading.
_HOMOGRAPHS: typing.Dict[str, typing.Tuple[typing.List[str], typing.List[str]]] = {
    "record": (["ɹ", "ˈɛ", "k", "ɚ", "d"], ["ɹ", "ɪ", "k", "ˈɔ", "ɹ", "d"]),
    "present": (["p", "ɹ", "ˈɛ", "z", "ə", "n", "t"],
             ["p", "ɹ", "ɪ", "z", "ˈɛ", "n", "t"]),
    "object": (["ˈɑ", "b", "d͡ʒ", "ɛ", "k", "t"],
             ["ə", "b", "d͡ʒ", "ˈɛ", "k", "t"]),
    "subject": (["s", "ˈʌ", "b", "d͡ʒ", "ɪ", "k", "t"],
             ["s", "ə", "b", "d͡ʒ", "ˈɛ", "k", "t"]),
    "conduct": (["k", "ˈɑ", "n", "d", "ʌ", "k", "t"],
             ["k", "ə", "n", "d", "ˈʌ", "k", "t"]),
    "produce": (["p", "ɹ", "ˈoʊ", "d", "u", "s"],
             ["p", "ɹ", "ə", "d", "ˈu", "s"]),
    "permit": (["p", "ˈɚ", "m", "ɪ", "t"], ["p", "ɚ", "m", "ˈɪ", "t"]),
    "contest": (["k", "ˈɑ", "n", "t", "ɛ", "s", "t"],
             ["k", "ə", "n", "t", "ˈɛ", "s", "t"]),
    "desert": (["d", "ˈɛ", "z", "ɚ", "t"], ["d", "ɪ", "z", "ˈɚ", "t"]),
    "refuse": (["ɹ", "ˈɛ", "f", "j", "u", "s"],
             ["ɹ", "ɪ", "f", "j", "ˈu", "z"]),
    "content": (["k", "ˈɑ", "n", "t", "ɛ", "n", "t"],
             ["k", "ə", "n", "t", "ˈɛ", "n", "t"]),
    "project": (["p", "ɹ", "ˈɑ", "d͡ʒ", "ɛ", "k", "t"],
             ["p", "ɹ", "ə", "d͡ʒ", "ˈɛ", "k", "t"]),
    "rebel": (["ɹ", "ˈɛ", "b", "ə", "l"], ["ɹ", "ɪ", "b", "ˈɛ", "l"]),
    "increase": (["ˈɪ", "n", "k", "ɹ", "i", "s"],
             ["ɪ", "n", "k", "ɹ", "ˈi", "s"]),
    "live": (["l", "ˈaɪ", "v"], ["l", "ˈɪ", "v"]),
    "lives": (["l", "ˈaɪ", "v", "z"], ["l", "ˈɪ", "v", "z"]),
}

# homographs whose cue-less default is the VERB column
_VERB_DEFAULT = frozenset({"lives", "recall"})

_HOMOGRAPHS_TAIL = {
    "wind": (["w", "ˈɪ", "n", "d"], ["w", "ˈaɪ", "n", "d"]),
    "bow": (["b", "ˈoʊ"], ["b", "ˈaʊ"]),
    "tear": (["t", "ˈɪ", "ɹ"], ["t", "ˈɛ", "ɹ"]),
    "close": (["k", "l", "ˈoʊ", "s"], ["k", "l", "ˈoʊ", "z"]),
    "use": (["j", "ˈu", "s"], ["j", "ˈu", "z"]),
    "house": (["h", "ˈaʊ", "s"], ["h", "ˈaʊ", "z"]),
    "excuse": (["ɪ", "k", "s", "k", "j", "ˈu", "s"],
             ["ɪ", "k", "s", "k", "j", "ˈu", "z"]),
    "separate": (["s", "ˈɛ", "p", "ɹ", "ə", "t"],
             ["s", "ˈɛ", "p", "ə", "ɹ", "ˌeɪ", "t"]),
    "graduate": (["ɡ", "ɹ", "ˈæ", "d͡ʒ", "u", "ə", "t"],
             ["ɡ", "ɹ", "ˈæ", "d͡ʒ", "u", "ˌeɪ", "t"]),
    "estimate": (["ˈɛ", "s", "t", "ə", "m", "ə", "t"],
             ["ˈɛ", "s", "t", "ə", "m", "ˌeɪ", "t"]),
    "alternate": (["ˈɔ", "l", "t", "ɚ", "n", "ə", "t"],
             ["ˈɔ", "l", "t", "ɚ", "n", "ˌeɪ", "t"]),
    "associate": (["ə", "s", "ˈoʊ", "ʃ", "i", "ə", "t"],
             ["ə", "s", "ˈoʊ", "ʃ", "i", "ˌeɪ", "t"]),
    "delegate": (["d", "ˈɛ", "l", "ə", "ɡ", "ə", "t"],
             ["d", "ˈɛ", "l", "ə", "ɡ", "ˌeɪ", "t"]),
    "duplicate": (["d", "ˈu", "p", "l", "ə", "k", "ə", "t"],
             ["d", "ˈu", "p", "l", "ə", "k", "ˌeɪ", "t"]),
    "moderate": (["m", "ˈɑ", "d", "ɚ", "ə", "t"],
             ["m", "ˈɑ", "d", "ɚ", "ˌeɪ", "t"]),
    "appropriate": (["ə", "p", "ɹ", "ˈoʊ", "p", "ɹ", "i", "ə", "t"],
             ["ə", "p", "ɹ", "ˈoʊ", "p", "ɹ", "i", "ˌeɪ", "t"]),
    "deliberate": (["d", "ɪ", "l", "ˈɪ", "b", "ɚ", "ə", "t"],
             ["d", "ɪ", "l", "ˈɪ", "b", "ɚ", "ˌeɪ", "t"]),
    "elaborate": (["ɪ", "l", "ˈæ", "b", "ɚ", "ə", "t"],
             ["ɪ", "l", "ˈæ", "b", "ɚ", "ˌeɪ", "t"]),
    "intimate": (["ˈɪ", "n", "t", "ə", "m", "ə", "t"],
             ["ˈɪ", "n", "t", "ə", "m", "ˌeɪ", "t"]),
    "advocate": (["ˈæ", "d", "v", "ə", "k", "ə", "t"],
             ["ˈæ", "d", "v", "ə", "k", "ˌeɪ", "t"]),
    "articulate": (["ɑ", "ɹ", "t", "ˈɪ", "k", "j", "ə", "l", "ə", "t"],
             ["ɑ", "ɹ", "t", "ˈɪ", "k", "j", "ə", "l", "ˌeɪ", "t"]),
    "invalid": (["ˈɪ", "n", "v", "ə", "l", "ə", "d"],
             ["ɪ", "n", "v", "ˈæ", "l", "ə", "d"]),
    "perfect": (["p", "ˈɚ", "f", "ɪ", "k", "t"],
             ["p", "ɚ", "f", "ˈɛ", "k", "t"]),
    "convert": (["k", "ˈɑ", "n", "v", "ɚ", "t"],
             ["k", "ə", "n", "v", "ˈɚ", "t"]),
    "insert": (["ˈɪ", "n", "s", "ɚ", "t"], ["ɪ", "n", "s", "ˈɚ", "t"]),
    "export": (["ˈɛ", "k", "s", "p", "ɔ", "ɹ", "t"],
             ["ɪ", "k", "s", "p", "ˈɔ", "ɹ", "t"]),
    "import": (["ˈɪ", "m", "p", "ɔ", "ɹ", "t"],
             ["ɪ", "m", "p", "ˈɔ", "ɹ", "t"]),
    "impact": (["ˈɪ", "m", "p", "æ", "k", "t"],
             ["ɪ", "m", "p", "ˈæ", "k", "t"]),
    "insult": (["ˈɪ", "n", "s", "ʌ", "l", "t"],
             ["ɪ", "n", "s", "ˈʌ", "l", "t"]),
    "progress": (["p", "ɹ", "ˈɑ", "ɡ", "ɹ", "ɛ", "s"],
             ["p", "ɹ", "ə", "ɡ", "ɹ", "ˈɛ", "s"]),
    "protest": (["p", "ɹ", "ˈoʊ", "t", "ɛ", "s", "t"],
             ["p", "ɹ", "ə", "t", "ˈɛ", "s", "t"]),
    "suspect": (["s", "ˈʌ", "s", "p", "ɛ", "k", "t"],
             ["s", "ə", "s", "p", "ˈɛ", "k", "t"]),
    "survey": (["s", "ˈɚ", "v", "eɪ"], ["s", "ɚ", "v", "ˈeɪ"]),
    "transfer": (["t", "ɹ", "ˈæ", "n", "s", "f", "ɚ"],
             ["t", "ɹ", "æ", "n", "s", "f", "ˈɚ"]),
    "transport": (["t", "ɹ", "ˈæ", "n", "s", "p", "ɔ", "ɹ", "t"],
             ["t", "ɹ", "æ", "n", "s", "p", "ˈɔ", "ɹ", "t"]),
    "upset": (["ˈʌ", "p", "s", "ɛ", "t"], ["ʌ", "p", "s", "ˈɛ", "t"]),
    "compound": (["k", "ˈɑ", "m", "p", "aʊ", "n", "d"],
             ["k", "ə", "m", "p", "ˈaʊ", "n", "d"]),
    "conflict": (["k", "ˈɑ", "n", "f", "l", "ɪ", "k", "t"],
             ["k", "ə", "n", "f", "l", "ˈɪ", "k", "t"]),
    "contract": (["k", "ˈɑ", "n", "t", "ɹ", "æ", "k", "t"],
             ["k", "ə", "n", "t", "ɹ", "ˈæ", "k", "t"]),
    "contrast": (["k", "ˈɑ", "n", "t", "ɹ", "æ", "s", "t"],
             ["k", "ə", "n", "t", "ɹ", "ˈæ", "s", "t"]),
    "convict": (["k", "ˈɑ", "n", "v", "ɪ", "k", "t"],
             ["k", "ə", "n", "v", "ˈɪ", "k", "t"]),
    "decrease": (["d", "ˈi", "k", "ɹ", "i", "s"],
             ["d", "ɪ", "k", "ɹ", "ˈi", "s"]),
    "discount": (["d", "ˈɪ", "s", "k", "aʊ", "n", "t"],
             ["d", "ɪ", "s", "k", "ˈaʊ", "n", "t"]),
    "escort": (["ˈɛ", "s", "k", "ɔ", "ɹ", "t"],
             ["ɪ", "s", "k", "ˈɔ", "ɹ", "t"]),
    "extract": (["ˈɛ", "k", "s", "t", "ɹ", "æ", "k", "t"],
             ["ɪ", "k", "s", "t", "ɹ", "ˈæ", "k", "t"]),
    "minute": (["m", "ˈɪ", "n", "ə", "t"],
             ["m", "aɪ", "n", "ˈu", "t"]),
    "console": (["k", "ˈɑ", "n", "s", "oʊ", "l"],
             ["k", "ə", "n", "s", "ˈoʊ", "l"]),
    "digest": (["d", "ˈaɪ", "d͡ʒ", "ɛ", "s", "t"],
             ["d", "aɪ", "d͡ʒ", "ˈɛ", "s", "t"]),
    "exploit": (["ˈɛ", "k", "s", "p", "l", "ɔɪ", "t"],
             ["ɪ", "k", "s", "p", "l", "ˈɔɪ", "t"]),
    "update": (["ˈʌ", "p", "d", "ˌeɪ", "t"],
             ["ʌ", "p", "d", "ˈeɪ", "t"]),
    "recall": (["ɹ", "ˈi", "k", "ɔ", "l"],
             ["ɹ", "ɪ", "k", "ˈɔ", "l"]),
    "addict": (["ˈæ", "d", "ɪ", "k", "t"],
             ["ə", "d", "ˈɪ", "k", "t"]),
    "intern": (["ˈɪ", "n", "t", "ɚ", "n"],
             ["ɪ", "n", "t", "ˈɚ", "n"]),
    "implant": (["ˈɪ", "m", "p", "l", "æ", "n", "t"],
             ["ɪ", "m", "p", "l", "ˈæ", "n", "t"]),
    "refund": (["ɹ", "ˈi", "f", "ʌ", "n", "d"],
             ["ɹ", "ɪ", "f", "ˈʌ", "n", "d"]),
    "reject": (["ɹ", "ˈi", "d͡ʒ", "ɛ", "k", "t"],
             ["ɹ", "ɪ", "d͡ʒ", "ˈɛ", "k", "t"]),
}
_HOMOGRAPHS.update(_HOMOGRAPHS_TAIL)

# Past-tense homographs: pronunciation flips after perfect-tense cues.
_PAST_HOMOGRAPHS: typing.Dict[str, typing.Tuple[typing.List[str], typing.List[str]]] = {
    "read": (["ɹ", "ˈi", "d"], ["ɹ", "ˈɛ", "d"]),
    "lead": (["l", "ˈi", "d"], ["l", "ˈɛ", "d"]),  # verb; the metal is past-form
    "dove": (["d", "ˈʌ", "v"], ["d", "ˈoʊ", "v"]),  # bird; past of dive
    "wound": (["w", "ˈu", "n", "d"], ["w", "ˈaʊ", "n", "d"]),  # injury; past of wind
}

# "bass" flips on topic words rather than syntax: the fish is [bæs],
# the music sense (default) is [beɪs].  Adjacent-word cues may be weak
# place words (lake/river); the CLAUSE-window set is restricted to
# strongly-fish words so "the bass player fell off the boat" keeps the
# music reading, while an adjacent music head noun wins outright.
_BASS_FISH_CUES = {
    "fish", "fishing", "caught", "catch", "lake", "river", "sea",
    "fresh", "smallmouth", "largemouth", "striped",
}
_BASS_FISH_CLAUSE_CUES = {
    "swam", "swim", "swims", "swimming", "fishing", "fish", "caught",
    "catch", "angler", "anglers", "fisherman", "bait", "hooked",
    "smallmouth", "largemouth", "spawn", "spawning",
}
_BASS_MUSIC_CUES = {
    "player", "players", "guitar", "guitars", "line", "lines", "drum",
    "drums", "amp", "amps", "solo", "clef", "singer", "voice", "band",
    "speaker", "speakers", "boost", "frequency", "frequencies",
    "volume", "notes",
}

# Semantic-field pairs: bow/tear are noun/noun homographs a POS tagger
# alone cannot split — topic words in the clause pick the reading
# (gruut 2.1's tagger + frequency priors covered most of these).
# "bow" = the knot/weapon [boʊ] near these objects ...
_BOW_OBJECT_CUES = {
    "arrow", "arrows", "violin", "cello", "fiddle", "ribbon",
    "ribbons", "hair", "gift", "gifts", "shoelace", "shoelaces",
    "tie", "tied", "tying", "wrap", "wrapped", "dress", "string",
}
# ... and the bending gesture [baʊ] after take/took or on stage
_BOW_BEND_CUES = {
    "took", "take", "takes", "taking", "bowed", "stage", "audience",
    "curtain", "applause", "performer", "performers", "actors",
    "deep", "polite", "respectful",
}
# "tear" = the teardrop [tɪɹ] in the crying field ...
_TEAR_CRY_CUES = {
    "eye", "eyes", "cry", "cried", "crying", "wept", "weep", "cheek",
    "cheeks", "rolled", "wiped", "shed", "sorrow", "joy", "single",
}
# ... and the rip [tɛɹ] as object of in/rip or near torn materials
_TEAR_RIP_CUES = {
    "paper", "page", "pages", "fabric", "cloth", "shirt", "jeans",
    "muscle", "ligament", "rip", "ripped", "hole", "mend", "mended",
    "repair", "repaired", "sleeve", "seam",
}

# Plural-subject rule stoplist: s-final tokens that pass the
# plural-of-lexicon-word test but are not plural subjects
_PLURAL_SUBJECT_STOP = {
    "news", "series", "species", "yes", "its", "his", "hers", "ours",
    "yours", "theirs", "always", "perhaps", "less", "unless", "plus",
    "thus", "as", "is", "was", "has", "does", "gas", "this",
}
# A homograph followed by one of these is in NOUN position even after a
# plural noun ("The sports record WAS broken") — copulas, auxiliaries,
# prepositions, and relative pronouns never follow a bare transitive verb
_NOUN_POSITION_NEXT = {
    "was", "is", "are", "were", "been", "be", "has", "have", "had",
    "will", "would", "may", "might", "must", "can", "could", "shall",
    "should", "of", "in", "on", "at", "by", "with", "from", "that",
    "which", "who", "went", "came", "stood", "rose", "fell",
}
# noun/ADJECTIVE homographs whose second column is a predicative
# adjective: a preceding copula selects it ("the password is invalid",
# "she is content")
_COPULAS = {
    "is", "was", "are", "were", "been", "be", "am", "seems", "seemed",
    "looks", "looked", "feels", "felt", "remains", "remained", "stays",
    "stayed", "being",
}
# only pairs whose SECOND column is the predicative adjective — for
# perfect/separate/present the adjective IS the first (default) column
_ADJ_AFTER_COPULA = {"invalid", "content"}

_VERB_CUES = {
    "to", "will", "would", "can", "could", "shall", "should", "may",
    "might", "must", "cannot", "don't", "doesn't", "didn't", "won't",
    "i", "we", "you", "they", "please", "not", "gonna", "let's",
}

# clause-initial adverbs that may precede a chained imperative ("Stop,
# then wind the crank") — consumed by _imperative_position, NOT generic
# verb cues: "Then record rainfall hit the city" keeps the noun reading
_IMPERATIVE_ADVERBS = {
    "then", "now", "just", "simply", "please", "first", "next", "finally",
}
_NOUN_CUES = {
    "the", "a", "an", "this", "that", "these", "those", "my", "your",
    "his", "her", "its", "our", "their", "no", "any", "some", "each",
    "every", "one", "new", "old", "public", "world",
}
_PAST_CUES = {"have", "has", "had", "was", "were", "been", "already", "he",
              "she", "i've", "we've", "they've", "he's", "she's"}

# Attributive next-word cues: a following head noun selects the reading a
# POS tagger would have picked (the reference's gruut 2.1 shipped one).
# "minute" before these nouns is the adjective /maɪnut/ ("a minute
# amount"), never the time noun.
_MINUTE_ADJ_NOUNS = {
    "amount", "amounts", "detail", "details", "quantity", "quantities",
    "particle", "particles", "trace", "traces", "difference",
    "differences", "fraction", "fractions", "change", "changes",
    "variation", "variations", "adjustment", "adjustments", "crack",
    "cracks", "flaw", "flaws", "error", "errors", "speck", "specks",
    "examination", "inspection", "quantity", "dose", "doses",
}
# "lead" before these compound heads is the metal /lɛd/ ("lead pipe"),
# not the verb/leading sense ("lead singer" stays /liːd/).
_LEAD_METAL_NOUNS = {
    "pipe", "pipes", "paint", "paints", "poisoning", "pencil",
    "pencils", "bullet", "bullets", "shield", "shielding", "acid",
    "exposure", "content", "levels", "contamination", "pollution",
    "dust", "foil", "shot", "solder", "weight", "weights", "sinker",
    "sinkers", "smelter", "lining",
}

# Clause-level temporal markers: a past-tense homograph anywhere in a
# clause containing one of these reads as past ("Yesterday I read...",
# "I read the book two days ago").
_TEMPORAL_PAST_WORDS = {
    "yesterday", "ago", "earlier", "previously", "recently", "already",
}
_TEMPORAL_LAST_NOUNS = {
    "week", "month", "year", "night", "evening", "morning", "summer",
    "winter", "spring", "fall", "autumn", "time", "sunday", "monday",
    "tuesday", "wednesday", "thursday", "friday", "saturday",
}
# determiner directly before a past-tense homograph = noun position
# ("the wound", "a dove") — blocks the clause-temporal past reading
_DETERMINERS = {
    "the", "a", "an", "this", "that", "these", "those", "my", "your",
    "his", "her", "its", "our", "their",
}


def _is_break_token(tok: str) -> bool:
    return bool(tok) and not tok[:1].isalnum()


def _clause_tokens(
    context: typing.Optional[typing.Sequence[str]], index: int
) -> typing.List[str]:
    """Lower-cased tokens of the clause around ``context[index]``.
    Clause = tokens between punctuation (breaks are passed through as
    their punctuation text)."""
    if not context or not (0 <= index < len(context)):
        return []
    lo = index
    while lo > 0 and not _is_break_token(context[lo - 1]):
        lo -= 1
    hi = index
    while hi + 1 < len(context) and not _is_break_token(context[hi + 1]):
        hi += 1
    return [context[k].lower() for k in range(lo, hi + 1)]


def _imperative_position(
    context: typing.Optional[typing.Sequence[str]],
    index: int,
    prev: str,
) -> bool:
    """True when the word opens its clause ("Wind the rope") or follows
    ONE clause-initial imperative adverb ("..., then wind the crank") —
    mid-clause adverbs do NOT count ("Then record rainfall hit" is a
    noun phrase).  Falls back to prev=="" when no token stream was
    provided (direct phonemize calls)."""
    if context and 0 <= index < len(context):
        if index == 0 or _is_break_token(context[index - 1]):
            return True
        return (
            context[index - 1].lower() in _IMPERATIVE_ADVERBS
            and (
                index - 1 == 0 or _is_break_token(context[index - 2])
            )
        )
    return not prev


def _clause_has_past_cue(
    context: typing.Optional[typing.Sequence[str]], index: int
) -> bool:
    """True if the clause around ``context[index]`` carries a temporal
    past marker."""
    clause = _clause_tokens(context, index)
    for k, tok in enumerate(clause):
        if tok in _TEMPORAL_PAST_WORDS:
            return True
        if tok == "last" and k + 1 < len(clause) and (
            clause[k + 1] in _TEMPORAL_LAST_NOUNS
        ):
            return True
    return False


def phonemize(
    word: str,
    prev: str = "",
    nxt: str = "",
    context: typing.Optional[typing.Sequence[str]] = None,
    index: int = -1,
) -> typing.List[str]:
    w = word.lower().strip()
    if not w:
        return []

    # ALL-CAPS initialisms spell their letters (USA, FBI, HTML) — the
    # gruut:letter role for spell-out; pronounceable 4+-letter acronyms
    # read as words (NASA, NATO).  Real words in caps (emphasis) hit
    # the lexicon below.
    if (
        word.isupper()
        and word.isalpha()
        and 2 <= len(word) <= 6
        and w not in LEXICON
        and (len(w) <= 3 or not _rules_acronym_readable(w))
    ):
        out: typing.List[str] = []
        for ch in w:
            out.extend(_LETTER_NAMES.get(ch, []))
        return out

    # noun/verb homographs: a light context heuristic stands in for
    # gruut's POS tagger.  Nouns are the default reading.
    if w in _HOMOGRAPHS:
        noun, verb = _HOMOGRAPHS[w]
        prev_l = prev.lower()
        nxt_l = nxt.lower()
        # semantic-field pairs first: clause topic words beat the
        # syntactic determiner cue ("He took a bow" — "a" says noun,
        # but "took" selects the bending gesture)
        if w == "bow":
            clause = set(_clause_tokens(context, index))
            if clause & _BOW_OBJECT_CUES or nxt_l in _BOW_OBJECT_CUES:
                return list(noun)  # boʊ — the knot / the weapon
            if clause & _BOW_BEND_CUES:
                return list(verb)  # baʊ — the gesture
        elif w == "tear":
            clause = set(_clause_tokens(context, index))
            if clause & _TEAR_CRY_CUES:
                return list(noun)  # tɪɹ — the teardrop
            if nxt_l == "in" or clause & _TEAR_RIP_CUES:
                return list(verb)  # tɛɹ — the rip
        # attributive position beats the determiner cue: "a minute
        # amount" is the adjective even though "a" says noun
        if w == "minute" and nxt_l in _MINUTE_ADJ_NOUNS:
            return list(verb)
        # predicative adjective after a copula: "the password is
        # invalid", "she is content" (second column = the adjective)
        if w in _ADJ_AFTER_COPULA and prev_l in _COPULAS:
            return list(verb)
        if prev_l in _NOUN_CUES:
            return list(noun)
        if prev_l in _VERB_CUES:
            return list(verb)
        # imperative-initial: the homograph opens its clause (possibly
        # after one imperative adverb) and takes a determined object — a
        # command reads as the verb ("Wind the rope", "then wind the
        # crank")
        if nxt_l in _DETERMINERS and _imperative_position(
            context, index, prev
        ):
            return list(verb)
        # plural-subject: a plural noun directly before the homograph is
        # its subject, so the homograph is the verb ("The farms produce
        # wheat") — gruut's POS tagger got these via NNS+VBP.  A
        # following copula/auxiliary/preposition marks NOUN position
        # instead ("The sports record was broken", "a sales increase in
        # revenue"): attributive plural nouns are compounds, not subjects.
        if (
            len(prev_l) >= 4
            and prev_l.endswith("s")
            and prev_l not in _PLURAL_SUBJECT_STOP
            and nxt_l not in _NOUN_POSITION_NEXT
            and (
                prev_l[:-1] in LEXICON
                or (prev_l.endswith("es") and prev_l[:-2] in LEXICON)
            )
        ):
            return list(verb)
        # "she lives here" is the overwhelmingly common cue-less reading
        return list(verb) if w in _VERB_DEFAULT else list(noun)
    if w in _PAST_HOMOGRAPHS:
        base, past = _PAST_HOMOGRAPHS[w]
        prev_l = prev.lower()
        if w == "lead" and nxt.lower() in _LEAD_METAL_NOUNS:
            return list(past)  # the metal shares the past-column form
        if prev_l in _PAST_CUES:
            return list(past)
        # determiner => noun position ("the wound", "a dove"): the base
        # column, regardless of clause-level temporal markers
        if prev_l in _DETERMINERS:
            return list(base)
        if _clause_has_past_cue(context, index):
            return list(past)
        return list(base)
    if w == "bass":
        if prev.lower() in _BASS_MUSIC_CUES or nxt.lower() in _BASS_MUSIC_CUES:
            return ["b", "ˈeɪ", "s"]
        clause = set(_clause_tokens(context, index))
        if (
            prev.lower() in _BASS_FISH_CUES
            or nxt.lower() in _BASS_FISH_CUES
            or clause & _BASS_FISH_CLAUSE_CUES
        ):
            return ["b", "ˈæ", "s"]
        return ["b", "ˈeɪ", "s"]

    if w in LEXICON:
        return list(LEXICON[w])

    # hyphenated compounds stay one word group but are pronounced part
    # by part (twenty-five, well-known) — gruut en-us did the same
    if "-" in w and len(w) > 1:
        parts = [p for p in w.split("-") if p]
        if len(parts) > 1:
            out: typing.List[str] = []
            for p in parts:
                out.extend(phonemize(p))
            return out

    # possessive / plural: stem + s
    if w.endswith("'s") and w[:-2] in LEXICON:
        stem = list(LEXICON[w[:-2]])
        last = stem[-1]
        if last in {"s", "z", "ʃ", "ʒ", "t͡ʃ", "d͡ʒ"}:
            return stem + ["ə", "z"]
        if last in {"p", "t", "k", "f", "θ"}:
            return stem + ["s"]
        return stem + ["z"]
    if w.endswith("s") and w[:-1] in LEXICON:
        stem = list(LEXICON[w[:-1]])
        last = stem[-1]
        if last in {"s", "z", "ʃ", "ʒ", "t͡ʃ", "d͡ʒ"}:
            return stem + ["ə", "z"]
        if last in {"p", "t", "k", "f", "θ"}:
            return stem + ["s"]
        return stem + ["z"]
    # -ed past tense
    if w.endswith("ed") and w[:-2] in LEXICON:
        stem = list(LEXICON[w[:-2]])
        last = stem[-1]
        if last in {"t", "d"}:
            return stem + ["ə", "d"]
        if last in {"p", "k", "f", "θ", "s", "ʃ", "t͡ʃ"}:
            return stem + ["t"]
        return stem + ["d"]
    # -ly adverbs
    if w.endswith("ly") and w[:-2] in LEXICON:
        return list(LEXICON[w[:-2]]) + ["l", "i"]
    # -ing forms
    if w.endswith("ing") and w[:-3] in LEXICON:
        return list(LEXICON[w[:-3]]) + ["ɪ", "ŋ"]
    if w.endswith("ing") and len(w) > 4 and w[:-3] + "e" in LEXICON:
        return list(LEXICON[w[:-3] + "e"]) + ["ɪ", "ŋ"]

    if len(w) == 1 and w in _LETTER_NAMES:
        return list(_LETTER_NAMES[w])
    # all-caps acronym heuristic: spell out short consonant clusters
    if len(w) <= 4 and word.isupper() and not any(c in "aeiou" for c in w):
        out: typing.List[str] = []
        for ch in w:
            out.extend(_LETTER_NAMES.get(ch, []))
        return out

    return _oov_phonemize(w)
phonemize.context_aware = True
