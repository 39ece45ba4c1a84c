"""Random node names: adjective-noun-hex12.

The port's copy of jylis_tpu/utils/namegen.py, whole.

Reference analog: name_generator.pony:5-545 (same shape of output — e.g.
"brisk-quokka-1a2b3c4d5e6f" — with our own word lists). Used when the
--addr flag carries an empty name (config.pony:69-72).
"""

from __future__ import annotations

import random

ADJECTIVES = [
    "amber", "arcane", "breezy", "brisk", "cedar", "cobalt", "coral",
    "crimson", "crisp", "dapper", "dusky", "eager", "ebony", "electric",
    "emerald", "fabled", "feral", "flint", "frosty", "gilded", "glacial",
    "golden", "granite", "hazel", "indigo", "ivory", "jade", "jolly",
    "keen", "limber", "lively", "lunar", "maroon", "mellow", "mirthful",
    "misty", "nimble", "obsidian", "opal", "pearly", "plucky", "quartz",
    "quiet", "rustic", "saffron", "sable", "scarlet", "silent", "silver",
    "sleek", "solar", "sprightly", "stellar", "stormy", "sturdy", "sunny",
    "swift", "tidal", "topaz", "tranquil", "umber", "velvet", "vivid",
    "zesty",
]

NOUNS = [
    "albatross", "antelope", "badger", "beacon", "bison", "bobcat",
    "caldera", "canyon", "caribou", "comet", "condor", "coyote", "crane",
    "delta", "dolphin", "falcon", "fjord", "gazelle", "geyser", "glacier",
    "grotto", "harbor", "heron", "ibex", "iguana", "jaguar", "kestrel",
    "lagoon", "lemur", "lynx", "manatee", "marmot", "meadow", "mesa",
    "narwhal", "nebula", "ocelot", "orchid", "osprey", "otter", "owl",
    "panther", "pelican", "pinnacle", "plateau", "puffin", "quasar",
    "quokka", "raven", "reef", "saguaro", "sequoia", "sparrow", "summit",
    "tundra", "vireo", "volcano", "wallaby", "walrus", "wombat", "yucca",
    "zenith", "zephyr", "zinnia",
]


def generate_name(rng: random.Random | None = None) -> str:
    rng = rng if rng is not None else random.Random()
    adj = rng.choice(ADJECTIVES)
    noun = rng.choice(NOUNS)
    hex12 = "".join(rng.choice("0123456789abcdef") for _ in range(12))
    return f"{adj}-{noun}-{hex12}"
