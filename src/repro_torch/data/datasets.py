"""Synthetic corpora mirroring the statistical structure of the paper's
evaluation suites (no external data — consistent with the paper's P2):

  - ``code``  (HumanEval-like): templated Python with heavy token repetition
              -> long context-N-gram matches (the paper observes w=10
              acceptances most often here, Fig. 4);
  - ``math``  (GSM8K-like): templated word problems + digit arithmetic ->
              wide acceptance-length distribution;
  - ``chat``  (MTBench-like): multi-turn Q&A with many unique tokens ->
              hardest for context N-grams, bigram does the work.
"""
from __future__ import annotations

import random
import zlib
from typing import List, Tuple

_NAMES = ["Ada", "Bert", "Caro", "Dan", "Eve", "Finn", "Gus", "Hana",
          "Ivan", "Jo", "Kira", "Liam"]
_ITEMS = ["apples", "books", "coins", "pens", "shells", "stamps", "tokens",
          "cards"]
_VERBS = ["buys", "sells", "finds", "loses", "makes", "trades"]
_TOPICS = ["the ocean", "a small town", "ancient history", "modern art",
           "machine learning", "gardening", "astronomy", "cooking",
           "chess strategy", "mountain hiking"]
_ADJS = ["brief", "detailed", "simple", "vivid", "formal", "playful"]

_CODE_FUNCS = [
    ("add_numbers", "a + b"), ("sub_numbers", "a - b"),
    ("mul_numbers", "a * b"), ("max_of_two", "a if a > b else b"),
    ("min_of_two", "a if a < b else b"),
]


def _code_example(rng: random.Random) -> str:
    name, expr = rng.choice(_CODE_FUNCS)
    n = rng.randint(2, 4)
    lines = [f"def {name}(a, b):",
             f"    \"\"\"Return {expr} for the inputs a and b.\"\"\"",
             f"    result = {expr}",
             "    return result",
             ""]
    for i in range(n):
        x, y = rng.randint(0, 20), rng.randint(0, 20)
        lines.append(f"assert {name}({x}, {y}) == {name}({x}, {y})")
    lines.append(f"print({name}({rng.randint(0,9)}, {rng.randint(0,9)}))")
    return "\n".join(lines)


def _math_example(rng: random.Random) -> str:
    who = rng.choice(_NAMES)
    item = rng.choice(_ITEMS)
    a, b, c = rng.randint(2, 30), rng.randint(2, 30), rng.randint(2, 9)
    return (f"Question: {who} has {a} {item}. {who} {rng.choice(_VERBS)} "
            f"{b} more {item} and then gives away {c} {item}. How many "
            f"{item} does {who} have now?\n"
            f"Answer: {who} starts with {a} {item}. After getting {b} more, "
            f"{who} has {a} + {b} = {a+b} {item}. After giving away {c}, "
            f"{who} has {a+b} - {c} = {a+b-c} {item}. The answer is "
            f"{a+b-c}.")


def _chat_example(rng: random.Random) -> str:
    topic = rng.choice(_TOPICS)
    adj = rng.choice(_ADJS)
    t2 = rng.choice(_TOPICS)
    return (f"User: Give me a {adj} explanation of {topic}.\n"
            f"Assistant: Here is a {adj} explanation of {topic}. The most "
            f"important thing to understand about {topic} is how its parts "
            f"fit together, and why people who study {topic} care about it.\n"
            f"User: Now compare {topic} with {t2}.\n"
            f"Assistant: Comparing {topic} with {t2}: both reward patience, "
            f"but {t2} demands different skills than {topic}.")


_MAKERS = {"code": _code_example, "math": _math_example, "chat": _chat_example}
TASKS = tuple(_MAKERS)


def make_corpus(task: str, n_examples: int, seed: int = 0) -> List[str]:
    # crc32, not hash(): str hashing is randomized per process
    # (PYTHONHASHSEED), which would make "seeded" corpora differ across
    # runs — benchmarks and sharded training both need them reproducible.
    rng = random.Random(seed * 7919 + zlib.crc32(task.encode()) % 1000)
    return [_MAKERS[task](rng) for _ in range(n_examples)]


def make_prompts(task: str, n: int, seed: int = 0
                 ) -> List[Tuple[str, str]]:
    """(prompt, reference-continuation) pairs: prompt = first half of an
    example, mimicking the paper's 'continue the benchmark example' setup."""
    out = []
    for ex in make_corpus(task, n, seed + 1):
        cut = len(ex) // 2
        out.append((ex[:cut], ex[cut:]))
    return out
