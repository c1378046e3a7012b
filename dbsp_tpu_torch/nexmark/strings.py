"""Host-side string dictionaries for Nexmark's channel/URL columns — a
copy of ``dbsp_tpu/nexmark/strings.py`` (pure Python).

Variable-length strings are dictionary-encoded on the host; fixed-width
codes flow on the device. This module OWNS the dictionary —
the real strings — and is constructed so that the device-side arithmetic in
q21/q22 (``queries.py``) is EXACTLY the string operation the reference
performs on the decoded text:

* q21 (queries/q21.rs): ``CASE channel WHEN 'apple'/'google'/'facebook'/
  'baidu' -> fixed ids ELSE regex-extract channel_id from the url``. Codes
  0-3 decode to the four named channels; any other code decodes to a URL
  whose ``channel_id`` query parameter IS ``100 + code`` — so the circuit's
  ``where(code < 4, code, 100 + code)`` equals regex extraction over the
  decoded string.
* q22 (queries/q22.rs): ``split_part(url, '/', 5..7)`` — dir1/dir2/dir3.
  URLs decode to ``https://b1.com/d<a>/d<b>/d<c>`` with a/b/c the same
  mod/div arithmetic the circuit applies, so splitting the decoded string
  reproduces the device output.

Encode at ingestion (`encode_channel`), decode at the serving boundary
(`decode_channel` / `channel_url` / `url_dirs`, used by output formatting
and the fidelity tests).
"""

from __future__ import annotations

from typing import Tuple

NAMED_CHANNELS = ("apple", "google", "facebook", "baidu")

# q21's CASE arm ids for the named channels are their codes (0..3); other
# channels get ids extracted from their URL's channel_id parameter
URL_CHANNEL_BASE = 100

# q22 splits (see url_dirs)
_D1, _D2, _D3 = 7, 11, 13


def decode_channel(code: int) -> str:
    """The channel STRING a code stands for."""
    if 0 <= code < len(NAMED_CHANNELS):
        return NAMED_CHANNELS[code]
    return f"channel-{code}"


def channel_url(code: int) -> str:
    """The bid URL for a channel code (the reference attaches one per bid)."""
    a, b, c3 = url_dirs_arith(code)
    return (f"https://b1.com/d{a}/d{b}/d{c3}"
            f"?channel_id={URL_CHANNEL_BASE + code}")


def encode_channel(name: str) -> int:
    if name in NAMED_CHANNELS:
        return NAMED_CHANNELS.index(name)
    assert name.startswith("channel-"), f"unknown channel {name!r}"
    return int(name.split("-", 1)[1])


# -- the string operations the queries model --------------------------------


def channel_id_of(code: int) -> int:
    """q21's CASE, evaluated over the REAL strings: named channels map to
    their fixed ids; others regex-extract channel_id from the URL."""
    if 0 <= code < len(NAMED_CHANNELS):
        return code
    url = channel_url(code)
    # the reference's `SPLIT(url, 'channel_id=')[2]`
    return int(url.split("channel_id=")[1])


def url_dirs_arith(code: int) -> Tuple[int, int, int]:
    """The dir1/dir2/dir3 codes embedded in the URL (and computed on device)."""
    return code % _D1, (code // _D1) % _D2, (code // (_D1 * _D2)) % _D3


def url_dirs_of(code: int) -> Tuple[str, str, str]:
    """q22's split_part over the REAL url string."""
    url = channel_url(code)
    path = url.split("?")[0]
    parts = path.split("/")  # ['https:', '', 'b1.com', d1, d2, d3]
    return parts[3], parts[4], parts[5]
