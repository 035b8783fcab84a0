"""Player/session layer of the PyTorch port (counterpart of mp3tpu.player)."""

from .engine import Player, open_track  # noqa: F401
from .queue import PlayQueue  # noqa: F401
from .scheduler import StreamScheduler, decode_batch_streams  # noqa: F401
from .sink import (CallbackSink, CollectSink, RawFileSink, RingBuffer,  # noqa: F401
                   Sink, WavFileSink)
