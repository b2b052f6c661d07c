"""HTTP server package of the port (aiohttp): web API, web UI, MaryTTS
compatibility; counterpart of ``larynx_tpu.server``."""

from larynx_tpu_torch.server.app import create_app  # noqa: F401
