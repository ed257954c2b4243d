"""A module fixture for the port's stream tests: the reference's program
builders, memoised for the module.

x265_tpu builds its device programs per Encoder, and tracing them is most
of a port stream test's time.  In a module whose reference encoders share
geometry and search / scan parameters (the QPs are inputs), each program
need be traced once: ``ref_programs`` patches the reference's pipeline
builders and lookahead programs for the module, each keyed by its
arguments other than the encoder (an argument with ``params``)."""

import pytest

import x265_tpu.encoder.device_pipeline as ref_dp
import x265_tpu.encoder.lookahead as ref_la


def _memo(real):
    memo = {}

    def build(*a, **kw):
        key = (tuple(x for x in a if not hasattr(x, "params")),
               tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = real(*a, **kw)
        return memo[key]
    return build


@pytest.fixture(scope="module", autouse=True)
def ref_programs():
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((ref_dp, ("build_i_pipeline", "build_p_pipeline",
                                     "build_b_pipeline")),
                           (ref_la, ("_build_lowres_program",
                                     "_build_bidir_program"))):
            for name in names:
                mp.setattr(mod, name, _memo(getattr(mod, name)))
        yield
