"""The port's CRUSH text compiler against the JAX package's, exactly.

``ceph_tpu_torch.crush.compiler`` and ``ceph_tpu.crush.compiler`` read and
write crushtool's text dialect.  On the hand-written sample maps of
``tests/test_tools.py`` and on ``build_hierarchy`` maps: the port's
``compile_text(t).to_bytes()`` equals the reference's for the same text,
the port's ``decompile`` of a map read from the reference's bytes equals
the reference's text, and malformed text raises ``CompileError`` in both
with the same message.  Maps cross between the packages only as bytes.
"""

import pytest

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush import compiler as ref_compiler
from ceph_tpu.crush.constants import BUCKET_STRAW2, BUCKET_UNIFORM
from ceph_tpu.crush.types import CrushMap as RefCrushMap
from ceph_tpu_torch.crush import compiler
from ceph_tpu_torch.crush.mapper import do_rule
from ceph_tpu_torch.crush.types import CrushMap

SAMPLE = """
# begin crush map
tunable choose_total_tries 50
tunable chooseleaf_stable 1

# devices
device 0 osd.0
device 1 osd.1
device 2 osd.2
device 3 osd.3

# types
type 0 osd
type 1 host
type 10 root

# buckets
host hostA {
\tid -1
\talg straw2
\thash 0\t# rjenkins1
\titem osd.0 weight 1.000000
\titem osd.1 weight 1.000000
}
host hostB {
\tid -2
\talg straw
\thash 0
\titem osd.2 weight 1.000000
\titem osd.3 weight 2.000000
}
root default {
\tid -3
\talg straw2
\thash 0
\titem hostA weight 2.000000
\titem hostB weight 3.000000
}

# rules
rule replicated_rule {
\truleset 0
\ttype replicated
\tmin_size 1
\tmax_size 10
\tstep take default
\tstep chooseleaf firstn 0 type host
\tstep emit
}
# end crush map
"""

ONE_LINE = ("type 0 osd type 1 host type 10 root "
            "device 0 osd.0 device 1 osd.1 "
            "host h { id -1 alg straw2 hash 0 "
            "item osd.0 weight 1.000000 item osd.1 weight 1.000000 } "
            "root default { id -2 alg straw2 hash 0 "
            "item h weight 2.000000 } "
            "rule r { ruleset 0 type replicated min_size 1 max_size 10 "
            "step take default step chooseleaf firstn 0 type osd "
            "step emit }")

# every set_* step, choose (not leaf) steps, an erasure rule by number,
# a uniform and a list bucket, an item without a weight
STEPS = """
tunable choose_local_tries 0
tunable choose_total_tries 100
device 0 osd.0
device 1 osd.1
device 2 osd.2
device 3 osd.3
device 5 osd.5
type 0 osd
type 1 host
type 3 rack
type 10 root
host h0 { id -1 alg uniform hash 0 item osd.0 weight 1.0 item osd.1 weight 1.0 }
host h1 { id -2 alg list hash 0 item osd.2 item osd.3 weight 0.5 }
host h2 { id -4 alg straw2 hash 0 item osd.5 weight 0.25 }
rack r0 { id -3 alg straw2 hash 0 item h0 weight 2.0 item h1 weight 1.5
          item h2 weight 0.25 }
rule ec {
  ruleset 4
  type erasure
  min_size 3
  max_size 20
  step set_chooseleaf_tries 5
  step set_choose_tries 100
  step set_choose_local_tries 0
  step set_choose_local_fallback_tries 0
  step set_chooseleaf_vary_r 1
  step set_chooseleaf_stable 1
  step take r0
  step choose indep 0 type host
  step chooseleaf indep 1 type osd
  step emit
}
rule by_number { ruleset 2 type 3 min_size 1 max_size 3
  step take r0 step choose firstn 2 type osd step emit }
"""

BAD = [
    ("forward reference", "type 0 osd\ntype 10 root\n"
     "root default { id -1 alg straw2 hash 0 item ghost weight 1.000000 }\n"),
    ("bad tunable", "tunable no_such_tunable 1\n"),
    ("truncated tunable", "tunable choose_total_tries"),
    ("unterminated block", "type 0 osd\ntype 1 host\ndevice 0 osd.0\n"
     "host h { id -1 alg straw2 item osd.0\n"),
    ("unknown alg", "type 0 osd\ntype 1 host\ndevice 0 osd.0\n"
     "host h { id -1 alg magic item osd.0 }\n"),
    ("bad bucket token", "type 0 osd\ntype 1 host\n"
     "host h { id -1 color red }\n"),
    ("unknown step", "type 0 osd\nrule r { step jump 3 }\n"),
    ("bad choose step", "type 0 osd\nrule r { step choose sideways 1 "
     "type osd step emit }\n"),
    ("unknown step type", "type 0 osd\nrule r { step choose firstn 1 "
     "type rack step emit }\n"),
    ("take of undefined", "type 0 osd\nrule r { step take nowhere }\n"),
    ("bad rule type", "rule r { type sideways }\n"),
    ("garbage", "hello world\n"),
    ("not a number", "device zero osd.0\n"),
    ("missing brace", "type 0 osd\nrule r step emit\n"),
]


def _ref_maps():
    """build_hierarchy maps as the reference builds them, each with a
    replicated and an EC rule; one with racks, one reweighted."""
    out = {}
    for name, n, per, racks in (("12x3-racks", 12, 3, 2),
                                ("1024x8", 1024, 8, 0),
                                ("30x3-racks", 30, 3, 2)):
        m = RefCrushMap()
        m.max_devices = n
        ref_builder.build_hierarchy(m, n, per, hosts_per_rack=racks)
        ref_builder.make_replicated_rule(m, "replicated_rule")
        ref_builder.make_erasure_rule(m, "ec_rule", size=6)
        out[name] = m
    host = out["30x3-racks"].bucket(-1)
    ref_builder.reweight_item(out["30x3-racks"], host, host.items[1], 0x8000)
    m = RefCrushMap()
    m.max_devices = 8
    m.set_tunables_profile("firefly")
    for d in range(8):
        m.name_map[d] = f"osd.{d}"
    hosts = [ref_builder.make_bucket(m, BUCKET_UNIFORM, 1,
                                     [2 * h, 2 * h + 1], [0x10000] * 2)
             for h in range(4)]
    for h, b in enumerate(hosts):
        m.name_map[b.id] = f"host{h}"
    root = ref_builder.make_bucket(m, BUCKET_STRAW2, 10,
                                   [h.id for h in hosts],
                                   [h.weight for h in hosts])
    m.name_map[root.id] = "default"
    ref_builder.make_replicated_rule(m, "rep")
    out["uniform-firefly"] = m
    return out


REF_MAPS = _ref_maps()


@pytest.mark.parametrize("name", sorted(REF_MAPS))
def test_decompile_of_reference_bytes_equals_reference_text(name):
    ref_map = REF_MAPS[name]
    want = ref_compiler.decompile(ref_map)
    port = CrushMap.from_bytes(ref_map.to_bytes())
    assert compiler.decompile(port) == want
    # and back: the same text compiles to the same bytes in both, which
    # are the map's own
    got = compiler.compile_text(want)
    assert got.to_bytes() == ref_compiler.compile_text(want).to_bytes() \
        == ref_map.to_bytes()
    assert compiler.decompile(got) == want


@pytest.mark.parametrize("text", [SAMPLE, ONE_LINE, STEPS],
                         ids=["sample", "one-line", "steps"])
def test_compile_text_bytes_equal_reference(text):
    port = compiler.compile_text(text)
    ref = ref_compiler.compile_text(text)
    assert port.to_bytes() == ref.to_bytes()
    assert port.summary() == ref.summary()
    assert compiler.decompile(port) == ref_compiler.decompile(ref)
    # the reference reads the port's bytes and writes the same text
    assert ref_compiler.decompile(RefCrushMap.from_bytes(port.to_bytes())) \
        == compiler.decompile(port)
    # a text round trip of the compiled map is stable
    again = compiler.compile_text(compiler.decompile(port))
    assert again.to_bytes() == port.to_bytes()


def test_compiled_sample_places_across_hosts():
    ms = compiler.compile_text(SAMPLE)
    assert ms.max_devices == 4 and ms.tunables.choose_total_tries == 50
    hosts = {0: "A", 1: "A", 2: "B", 3: "B"}
    for x in range(64):
        got = do_rule(ms, 0, x, 2, [0x10000] * 4)
        assert len(got) == 2 and hosts[got[0]] != hosts[got[1]]


@pytest.mark.parametrize("case", [b[0] for b in BAD])
def test_compile_errors_match_reference(case):
    text = dict(BAD)[case]
    with pytest.raises(ref_compiler.CompileError) as ref_err:
        ref_compiler.compile_text(text)
    with pytest.raises(compiler.CompileError) as err:
        compiler.compile_text(text)
    assert str(err.value) == str(ref_err.value)
    assert isinstance(err.value, ValueError)
