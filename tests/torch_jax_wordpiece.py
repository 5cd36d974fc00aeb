"""A module-scoped autouse fixture for the port's tests that hold the port's
WordPiece ids against the JAX package's.

The JAX package's tokenizer takes its native library
(``openvision_tpu/native/libwordpiece.so``) whenever the file is there and
passes one canary string. Tests build that library with a plain ``make``
in place (no temp name, no rename), from whichever worker first runs
``tests/test_native.py``, and ``get_tokenizer``'s cache keeps whatever a
worker loaded first for the rest of its session. So the JAX side's ids can
depend on the order of the tests and on what the tree held when the run
began. The JAX package's Python path is the definition that its native
library is held to, so the port is compared with that: in a module that
imports this fixture, ``openvision_tpu.native.wordpiece.load_native``
returns None and both packages' tokenizer caches start and end empty, so
neither side reuses a tokenizer another module built.

    from torch_jax_wordpiece import jax_python_wordpiece  # noqa: F401
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def jax_python_wordpiece():
    from openvision_tpu.data import tokenizer as jax_tokenizer
    from openvision_tpu.native import wordpiece as jax_wordpiece
    from openvision_tpu_torch.data import tokenizer

    def clear():
        jax_tokenizer.get_tokenizer.cache_clear()
        tokenizer.get_tokenizer.cache_clear()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wordpiece, "load_native", lambda vocab_path: None)
        clear()
        yield
    clear()
