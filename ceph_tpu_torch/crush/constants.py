"""CRUSH constants and tunable profiles.

Reference parity: crush/crush.h (bucket algs :111-117, rule ops :48-63,
CRUSH_ITEM_* :33-34) and CrushWrapper tunable profiles
(crush/CrushWrapper.h:105-151).
"""

CRUSH_MAX_DEPTH = 10
CRUSH_ITEM_UNDEF = 0x7FFFFFFE  # internal: undefined result
CRUSH_ITEM_NONE = 0x7FFFFFFF   # no result
CRUSH_MAX_DEVICE_WEIGHT = 100 * 0x10000
CRUSH_MAX_BUCKET_WEIGHT = 65535 * 0x10000

# bucket algorithms
BUCKET_UNIFORM = 1
BUCKET_LIST = 2
BUCKET_TREE = 3
BUCKET_STRAW = 4
BUCKET_STRAW2 = 5
BUCKET_ALG_NAMES = {
    BUCKET_UNIFORM: "uniform", BUCKET_LIST: "list", BUCKET_TREE: "tree",
    BUCKET_STRAW: "straw", BUCKET_STRAW2: "straw2",
}
BUCKET_ALG_BY_NAME = {v: k for k, v in BUCKET_ALG_NAMES.items()}

# hash functions
HASH_RJENKINS1 = 0

# rule step opcodes
RULE_NOOP = 0
RULE_TAKE = 1
RULE_CHOOSE_FIRSTN = 2
RULE_CHOOSE_INDEP = 3
RULE_EMIT = 4
RULE_CHOOSELEAF_FIRSTN = 6
RULE_CHOOSELEAF_INDEP = 7
RULE_SET_CHOOSE_TRIES = 8
RULE_SET_CHOOSELEAF_TRIES = 9
RULE_SET_CHOOSE_LOCAL_TRIES = 10
RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
RULE_SET_CHOOSELEAF_VARY_R = 12
RULE_SET_CHOOSELEAF_STABLE = 13

RULE_OP_NAMES = {
    RULE_NOOP: "noop", RULE_TAKE: "take",
    RULE_CHOOSE_FIRSTN: "choose firstn", RULE_CHOOSE_INDEP: "choose indep",
    RULE_EMIT: "emit",
    RULE_CHOOSELEAF_FIRSTN: "chooseleaf firstn",
    RULE_CHOOSELEAF_INDEP: "chooseleaf indep",
    RULE_SET_CHOOSE_TRIES: "set_choose_tries",
    RULE_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
    RULE_SET_CHOOSE_LOCAL_TRIES: "set_choose_local_tries",
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES: "set_choose_local_fallback_tries",
    RULE_SET_CHOOSELEAF_VARY_R: "set_chooseleaf_vary_r",
    RULE_SET_CHOOSELEAF_STABLE: "set_chooseleaf_stable",
}

# rule types (pool semantics)
RULE_TYPE_REPLICATED = 1
RULE_TYPE_ERASURE = 3

S64_MIN = -(1 << 63)

# Tunable profiles (reference: CrushWrapper.h:105-151).  Each maps to the
# crush_map tunable fields; "optimal" at this reference version == jewel.
TUNABLE_PROFILES = {
    "legacy": dict(choose_local_tries=2, choose_local_fallback_tries=5,
                   choose_total_tries=19, chooseleaf_descend_once=0,
                   chooseleaf_vary_r=0, chooseleaf_stable=0,
                   straw_calc_version=0),
    "argonaut": dict(choose_local_tries=2, choose_local_fallback_tries=5,
                     choose_total_tries=19, chooseleaf_descend_once=0,
                     chooseleaf_vary_r=0, chooseleaf_stable=0,
                     straw_calc_version=0),
    "bobtail": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                    choose_total_tries=50, chooseleaf_descend_once=1,
                    chooseleaf_vary_r=0, chooseleaf_stable=0,
                    straw_calc_version=0),
    "firefly": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                    choose_total_tries=50, chooseleaf_descend_once=1,
                    chooseleaf_vary_r=1, chooseleaf_stable=0,
                    straw_calc_version=0),
    "hammer": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                   choose_total_tries=50, chooseleaf_descend_once=1,
                   chooseleaf_vary_r=1, chooseleaf_stable=0,
                   straw_calc_version=1),
    "jewel": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                  choose_total_tries=50, chooseleaf_descend_once=1,
                  chooseleaf_vary_r=1, chooseleaf_stable=1,
                  straw_calc_version=1),
}
TUNABLE_PROFILES["optimal"] = TUNABLE_PROFILES["jewel"]
# reference set_tunables_default() = firefly + straw_calc_version=1
# (CrushWrapper.h:167-170) — note chooseleaf_stable stays 0
TUNABLE_PROFILES["default"] = dict(TUNABLE_PROFILES["firefly"],
                                   straw_calc_version=1)
