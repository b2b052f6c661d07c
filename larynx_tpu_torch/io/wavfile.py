# Copied from larynx_tpu/io/wavfile.py (numpy and the standard library only).
"""Minimal RIFF/WAVE reader and writer.

Clean-room replacement for the vendored scipy reader in the reference
(``larynx/wavfile.py:541,721``).  Supports the formats the TTS pipeline
actually produces/consumes: PCM 8/16/24/32-bit, IEEE float32/64, mono or
multi-channel, plus WAVE_FORMAT_EXTENSIBLE headers.  Works with file paths
and binary file-like objects (e.g. ``io.BytesIO`` for the HTTP server).
"""

import io
import struct
import typing

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFileError(Exception):
    """Raised on malformed or unsupported WAV data."""


def _open(file, mode: str):
    if hasattr(file, "read") or hasattr(file, "write"):
        return file, False
    return open(file, mode), True


# -----------------------------------------------------------------------------


def read(file) -> typing.Tuple[int, np.ndarray]:
    """Read a WAV file.

    Returns ``(sample_rate, data)`` where ``data`` is [n_samples] for mono
    or [n_samples, n_channels] otherwise.  dtype follows the container:
    uint8 / int16 / int32 (also used for 24-bit) / float32 / float64.
    """
    fh, should_close = _open(file, "rb")
    try:
        riff = fh.read(12)
        if len(riff) < 12 or riff[:4] not in (b"RIFF", b"RIFX"):
            raise WavFileError("not a RIFF file")
        big_endian = riff[:4] == b"RIFX"
        end = ">" if big_endian else "<"
        if riff[8:12] != b"WAVE":
            raise WavFileError("not a WAVE file")

        fmt = None
        data = None
        while True:
            header = fh.read(8)
            if len(header) < 8:
                break
            chunk_id, size = header[:4], struct.unpack(end + "I", header[4:])[0]
            if chunk_id == b"fmt ":
                raw = fh.read(size)
                if len(raw) < 16:
                    raise WavFileError("fmt chunk too small")
                (
                    audio_format,
                    n_channels,
                    sample_rate,
                    _byte_rate,
                    block_align,
                    bits,
                ) = struct.unpack(end + "HHIIHH", raw[:16])
                if audio_format == WAVE_FORMAT_EXTENSIBLE and len(raw) >= 40:
                    # sub-format GUID: first 2 bytes are the real format tag
                    audio_format = struct.unpack(end + "H", raw[24:26])[0]
                fmt = (audio_format, n_channels, sample_rate, block_align, bits)
            elif chunk_id == b"data":
                data = fh.read(size)
                if size % 2 == 1:
                    fh.read(1)
            else:
                fh.seek(size + (size % 2), io.SEEK_CUR)

        if fmt is None or data is None:
            raise WavFileError("missing fmt or data chunk")

        audio_format, n_channels, sample_rate, _block_align, bits = fmt
        order = ">" if big_endian else "<"
        if audio_format == WAVE_FORMAT_PCM:
            if bits == 8:
                array = np.frombuffer(data, dtype=np.uint8)
            elif bits == 16:
                array = np.frombuffer(data, dtype=order + "i2")
            elif bits == 24:
                raw = np.frombuffer(data, dtype=np.uint8)
                raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
                as32 = np.zeros((raw.shape[0], 4), dtype=np.uint8)
                if big_endian:
                    as32[:, :3] = raw
                else:
                    as32[:, 1:] = raw  # little-endian: place in upper 3 bytes
                # left-justified in int32 (lowest byte zero), matching
                # scipy / the reference's vendored reader — full-scale
                # 24-bit reads as full-scale int32
                array = as32.view(order + "i4").reshape(-1)
            elif bits == 32:
                array = np.frombuffer(data, dtype=order + "i4")
            else:
                raise WavFileError(f"unsupported PCM bit depth: {bits}")
        elif audio_format == WAVE_FORMAT_IEEE_FLOAT:
            if bits == 32:
                array = np.frombuffer(data, dtype=order + "f4")
            elif bits == 64:
                array = np.frombuffer(data, dtype=order + "f8")
            else:
                raise WavFileError(f"unsupported float bit depth: {bits}")
        else:
            raise WavFileError(f"unsupported format tag: {audio_format:#x}")

        if n_channels > 1:
            array = array[: (len(array) // n_channels) * n_channels]
            array = array.reshape(-1, n_channels)
        return sample_rate, array
    finally:
        if should_close:
            fh.close()


# -----------------------------------------------------------------------------


def write(file, rate: int, data: np.ndarray) -> None:
    """Write a WAV file.

    ``data`` is [n_samples] or [n_samples, n_channels].  dtype selects the
    container format: uint8/int16/int32 -> PCM, float32/float64 -> IEEE float.
    """
    data = np.asarray(data)
    if data.ndim == 1:
        n_channels = 1
    elif data.ndim == 2:
        n_channels = data.shape[1]
    else:
        raise WavFileError("data must be 1-D or 2-D")

    kind_map = {
        np.dtype(np.uint8): (WAVE_FORMAT_PCM, 8),
        np.dtype(np.int16): (WAVE_FORMAT_PCM, 16),
        np.dtype(np.int32): (WAVE_FORMAT_PCM, 32),
        np.dtype(np.float32): (WAVE_FORMAT_IEEE_FLOAT, 32),
        np.dtype(np.float64): (WAVE_FORMAT_IEEE_FLOAT, 64),
    }
    if data.dtype not in kind_map:
        raise WavFileError(f"unsupported dtype: {data.dtype}")
    audio_format, bits = kind_map[data.dtype]

    payload = data.astype(data.dtype.newbyteorder("<"), copy=False).tobytes()
    block_align = n_channels * bits // 8
    byte_rate = rate * block_align

    fmt_chunk = struct.pack(
        "<HHIIHH", audio_format, n_channels, rate, byte_rate, block_align, bits
    )
    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        # float WAVs conventionally carry a fact chunk + cbSize=0 in fmt
        fmt_chunk += struct.pack("<H", 0)
        fact_chunk = b"fact" + struct.pack("<II", 4, data.shape[0])
    else:
        fact_chunk = b""

    body = (
        b"WAVE"
        + b"fmt "
        + struct.pack("<I", len(fmt_chunk))
        + fmt_chunk
        + fact_chunk
        + b"data"
        + struct.pack("<I", len(payload))
        + payload
    )
    if len(payload) % 2 == 1:
        body += b"\x00"

    fh, should_close = _open(file, "wb")
    try:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    finally:
        if should_close:
            fh.close()


def wav_bytes(rate: int, data: np.ndarray) -> bytes:
    """Serialize audio to an in-memory WAV (used by the HTTP server/CLI)."""
    buf = io.BytesIO()
    write(buf, rate, data)
    return buf.getvalue()
