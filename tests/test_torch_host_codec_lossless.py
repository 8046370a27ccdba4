"""The host coder of test_torch_host_codec.py on qres_tiny_lossless (the
same tests, in a file of their own to keep each file's run short): the
lossless head coded on the host as per-image strings, the device coder
refused."""
import pytest

from tests.test_torch_host_codec import (  # noqa: F401  (collected here)
    Models, image, test_entry_points_of_the_fused_coder_refuse_the_staged,
    test_host_files_decode_across_packages,
    test_roundtrip_exact_and_equal_to_legacy_fused,
    test_symbols_and_indexes_match_jax,
    test_wire_bytes_from_jax_symbols_equal_jax)


@pytest.fixture(scope='module')
def models():
    return Models('qres_tiny_lossless')
