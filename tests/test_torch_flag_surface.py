"""Each subcommand of the port takes modkit_tpu's flags.

One case per ported subcommand: the port's subparser has the same option
strings, ``dest``s, defaults, choices and ``nargs`` as modkit_tpu's, and
the same positional arguments. ``pileup`` also takes ``--device``, which
modkit_tpu does not have (the port's runs choose their device).
"""

import argparse

import pytest

from modkit_tpu.cli import build_parser as ref_parser
from modkit_tpu_torch.cli import build_parser as port_parser

SUBCOMMANDS = [
    ("pileup",), ("summary",), ("sample-probs",), ("adjust-mods",),
    ("call-mods",), ("update-tags",), ("repair",), ("modbam", "check-tags"),
    ("modbam", "sample-reads"), ("extract", "full"), ("extract", "calls"),
    ("dmr", "pair"), ("dmr", "multi"), ("stats",), ("localize",),
    ("bedmethyl", "merge"), ("bedmethyl", "tobigwig"), ("validate",),
    ("pileup-hemi",), ("entropy",), ("motif", "search"), ("motif", "refine"),
    ("motif", "evaluate"), ("motif", "bed"), ("find-motifs",),
]
# flags of the port's subparser that modkit_tpu's does not have
PORT_ONLY = {("pileup",): {"--device"}}


def _subparser(parser, path):
    for name in path:
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        parser = sub.choices[name]
    return parser


def _surface(parser, skip=()):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction) or set(a.option_strings) & set(
                skip):
            continue
        key = tuple(a.option_strings) or ("positional", a.dest)
        out[key] = (a.dest, a.default, a.choices, a.nargs, a.required,
                    type(a).__name__)
    return out


@pytest.mark.parametrize("path", SUBCOMMANDS, ids=" ".join)
def test_subcommand_has_modkit_tpu_flags(path):
    port = _subparser(port_parser(), path)
    ref = _surface(_subparser(ref_parser(), path))
    assert _surface(port, PORT_ONLY.get(path, ())) == ref
    assert len(ref) >= 1
    for flag in PORT_ONLY.get(path, ()):
        assert flag in port._option_string_actions


def test_the_port_has_exactly_these_subcommands():
    sub = next(a for a in port_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == {p[0] for p in SUBCOMMANDS} | {"mb",
                                                               "localise"}
