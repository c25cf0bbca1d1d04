"""Network front door (counterpart of :mod:`jaxstream.gateway`).

Submit a :class:`~jaxstream_torch.serve.ScenarioRequest` as JSON, stream
per-segment progress events, receive the final summary and the
byte-preserving output arrays on the same connection.  :mod:`.protocol`
is pure serialization, :mod:`.gateway` the front end on the standard
library (``asyncio.start_server`` with its own HTTP/1.1 and WebSocket
framing: the machine with the GPU has no aiohttp), :mod:`.client` a
blocking stdlib client.
"""

from . import protocol
from .client import (GatewayError, get_json, get_text, post_json,
                     submit_streaming)
from .gateway import Gateway

__all__ = ["Gateway", "GatewayError", "get_json", "get_text",
           "post_json", "protocol", "submit_streaming"]
