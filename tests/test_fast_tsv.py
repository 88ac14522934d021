"""Native TSV loader: parity with pandas and with the pure-Python fallback."""

import numpy as np
import pandas as pd
import pytest

from multimodalmusig_tpu.utils import fast_tsv

from conftest import requires_brca_data

from multimodalmusig_tpu.utils.data import brca_counts_path

SNV = brca_counts_path("brca-eu_snv_counts.tsv")


def test_native_builds():
    assert fast_tsv.native_available(), "g++ toolchain expected in this image"


@requires_brca_data
def test_matches_pandas_on_bundled_data():
    counts, terms, samples = fast_tsv.read_counts_tsv(SNV)
    df = pd.read_csv(SNV, sep="\t")
    assert terms == list(df["term"])
    assert samples == list(df.columns[1:])
    np.testing.assert_array_equal(counts, df.iloc[:, 1:].to_numpy(dtype=np.float64))


@requires_brca_data
def test_python_fallback_matches_native():
    cn, tn, sn = fast_tsv.read_counts_tsv(SNV, prefer_native=True)
    cp, tp, sp = fast_tsv.read_counts_tsv(SNV, prefer_native=False)
    np.testing.assert_array_equal(cn, cp)
    assert tn == tp and sn == sp


def test_handles_trailing_newline_and_crlf(tmp_path):
    p = tmp_path / "t.tsv"
    p.write_text("term\ts1\ts2\r\nA\t1\t2\r\nB\t3\t4\n\n")
    counts, terms, samples = fast_tsv.read_counts_tsv(str(p))
    assert terms == ["A", "B"]
    assert samples == ["s1", "s2"]
    np.testing.assert_array_equal(counts, [[1, 2], [3, 4]])


def test_float_counts(tmp_path):
    p = tmp_path / "t.tsv"
    p.write_text("term\ts1\nA\t1.5\nB\t2.25\n")
    counts, terms, _ = fast_tsv.read_counts_tsv(str(p))
    np.testing.assert_array_equal(counts[:, 0], [1.5, 2.25])


def test_missing_file_raises():
    with pytest.raises(OSError):
        fast_tsv.read_counts_tsv("/nonexistent/file.tsv")


def test_malformed_rows_raise(tmp_path):
    """Short/long/empty-field rows must error, not silently misalign."""
    for body in (
        "term\ts1\ts2\nA\t1\nB\t3\t4\n",        # short row
        "term\ts1\ts2\nA\t1\t2\t9\nB\t3\t4\n",  # long row
        "term\ts1\ts2\nA\t1\t\nB\t3\t4\n",      # empty field
    ):
        p = tmp_path / "bad.tsv"
        p.write_text(body)
        with pytest.raises((OSError, ValueError)):
            fast_tsv.read_counts_tsv(str(p))


def test_native_builds_from_tracked_source(tmp_path):
    """The library is built from native/tsv_loader.cpp, records the source
    hash beside it, and is rebuilt only when that hash changes."""
    import shutil

    src = tmp_path / "tsv_loader.cpp"
    shutil.copy(fast_tsv._SRC, src)
    lib = str(tmp_path / "libtsv_loader.so")
    assert fast_tsv.build_native(str(src), lib) == lib
    stamp = (tmp_path / "libtsv_loader.so.sha256").read_text().strip()
    assert stamp == fast_tsv._source_key(str(src))
    inode = (tmp_path / "libtsv_loader.so").stat().st_ino
    fast_tsv.build_native(str(src), lib)  # same source: no rebuild
    assert (tmp_path / "libtsv_loader.so").stat().st_ino == inode
    src.write_text(src.read_text() + "\n// changed\n")
    fast_tsv.build_native(str(src), lib)  # new hash: rebuilt
    assert (tmp_path / "libtsv_loader.so").stat().st_ino != inode
    assert (tmp_path / "libtsv_loader.so.sha256").read_text().strip() != stamp
