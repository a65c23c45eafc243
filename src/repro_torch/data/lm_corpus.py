"""Character-level LM corpus (paper Fig. 2: Shakespeare / nanoGPT setting).

A copy of ``repro.data.lm_corpus`` (the port imports nothing of the
reference package); the arrays it builds are the reference's exactly.

The real tinyshakespeare file (1,003,854 train tokens) is not available
offline, so the corpus here is a set of genuine public-domain Shakespeare
passages embedded below (~6 KB), deterministically tiled with passage-level
shuffling to the requested size.  Loss VALUES are therefore not comparable
to the paper's (the effective entropy is lower); loss TRENDS and
model-vs-model comparisons are (DESIGN.md §8).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

PASSAGES = [
    """To be, or not to be, that is the question:
Whether 'tis nobler in the mind to suffer
The slings and arrows of outrageous fortune,
Or to take arms against a sea of troubles
And by opposing end them. To die: to sleep;
No more; and by a sleep to say we end
The heart-ache and the thousand natural shocks
That flesh is heir to, 'tis a consummation
Devoutly to be wish'd. To die, to sleep;
To sleep: perchance to dream: ay, there's the rub;
For in that sleep of death what dreams may come
When we have shuffled off this mortal coil,
Must give us pause.""",
    """Shall I compare thee to a summer's day?
Thou art more lovely and more temperate:
Rough winds do shake the darling buds of May,
And summer's lease hath all too short a date:
Sometime too hot the eye of heaven shines,
And often is his gold complexion dimm'd;
And every fair from fair sometime declines,
By chance or nature's changing course untrimm'd;
But thy eternal summer shall not fade.""",
    """Tomorrow, and tomorrow, and tomorrow,
Creeps in this petty pace from day to day
To the last syllable of recorded time,
And all our yesterdays have lighted fools
The way to dusty death. Out, out, brief candle!
Life's but a walking shadow, a poor player
That struts and frets his hour upon the stage
And then is heard no more: it is a tale
Told by an idiot, full of sound and fury,
Signifying nothing.""",
    """But, soft! what light through yonder window breaks?
It is the east, and Juliet is the sun.
Arise, fair sun, and kill the envious moon,
Who is already sick and pale with grief,
That thou her maid art far more fair than she.""",
    """Friends, Romans, countrymen, lend me your ears;
I come to bury Caesar, not to praise him.
The evil that men do lives after them;
The good is oft interred with their bones;
So let it be with Caesar. The noble Brutus
Hath told you Caesar was ambitious:
If it were so, it was a grievous fault,
And grievously hath Caesar answer'd it.""",
    """All the world's a stage,
And all the men and women merely players:
They have their exits and their entrances;
And one man in his time plays many parts,
His acts being seven ages. At first the infant,
Mewling and puking in the nurse's arms.""",
    """Now is the winter of our discontent
Made glorious summer by this sun of York;
And all the clouds that lour'd upon our house
In the deep bosom of the ocean buried.
Now are our brows bound with victorious wreaths;
Our bruised arms hung up for monuments.""",
    """The quality of mercy is not strain'd,
It droppeth as the gentle rain from heaven
Upon the place beneath: it is twice blest;
It blesseth him that gives and him that takes:
'Tis mightiest in the mightiest: it becomes
The throned monarch better than his crown.""",
    """If music be the food of love, play on;
Give me excess of it, that, surfeiting,
The appetite may sicken, and so die.
That strain again! it had a dying fall:
O, it came o'er my ear like the sweet sound,
That breathes upon a bank of violets,
Stealing and giving odour!""",
    """Once more unto the breach, dear friends, once more;
Or close the wall up with our English dead.
In peace there's nothing so becomes a man
As modest stillness and humility:
But when the blast of war blows in our ears,
Then imitate the action of the tiger;
Stiffen the sinews, summon up the blood.""",
]

VOCAB_SIZE = 256          # byte-level


def build_corpus(target_bytes: int = 400_000, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (train_data, test_data) as uint8 arrays, ~9:1 split."""
    rng = np.random.default_rng(seed)
    chunks = []
    size = 0
    while size < target_bytes:
        order = rng.permutation(len(PASSAGES))
        for i in order:
            chunks.append(PASSAGES[i].encode() + b"\n\n")
            size += len(chunks[-1])
    data = np.frombuffer(b"".join(chunks), np.uint8)
    split = int(len(data) * 0.9)
    return data[:split].copy(), data[split:].copy()


def lm_batch(data: np.ndarray, seed: int, step: int, batch: int,
             seq_len: int) -> Dict[str, np.ndarray]:
    """Deterministic (seed, step) -> batch of next-char prediction."""
    rng = np.random.default_rng(np.random.PCG64(seed * 7_919 + step))
    starts = rng.integers(0, len(data) - seq_len - 1, size=batch)
    tokens = np.stack([data[s:s + seq_len] for s in starts]).astype(np.int32)
    labels = np.stack([data[s + 1:s + seq_len + 1]
                       for s in starts]).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def decode_bytes(ids) -> str:
    return bytes(int(i) for i in ids).decode(errors="replace")
