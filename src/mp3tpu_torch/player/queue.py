"""Multi-track session: a gapless play queue over single-track Players
(counterpart of mp3tpu.player.queue, on the port's Player and track_levels,
with an explicit device).

The reference's usage is article-at-a-time listening (reference
README.md:46, SURVEY.md §0.1); a queue of articles/tracks is the
session layer above D5. Transitions are gapless by construction: each
track's Player trims its own LAME delay/padding (D1), so back-to-back
pushes into the ONE shared sink splice sample-exactly — album playback
has no seam, and queue output is bit-identical to decoding each file
alone and concatenating (test_queue pins it).

Players are opened lazily (one at a time): opening parses the container
only, and the engine's SymbolSource unpacks granule windows on demand,
so a 100-article queue costs one track's working state. Per-session
settings (gain/EQ/speed) are re-applied to each track as it opens.
"""
from __future__ import annotations

from ..metrics import Metrics
from .engine import Player
from .sink import CollectSink, Sink


class PlayQueue:
    """Sequential playback of many tracks into one sink."""

    def __init__(self, paths, sink: Sink | None = None,
                 gain_db: float | None = None, eq_gains_db=None,
                 apply_gapless: bool = True, speed: float | None = None,
                 normalize: bool = False, target_db: float | None = None,
                 device="cuda"):
        # materialize BEFORE the guard: an empty iterator is truthy
        self._paths = list(paths)
        if not self._paths:
            raise ValueError("empty queue")
        self.device = device
        self.sink = sink or CollectSink()
        self._fmt = None               # (sample_rate, channels) of track 0
        self._gain_db = gain_db
        self._eq_gains_db = eq_gains_db
        self._apply_gapless = apply_gapless
        self._speed = speed
        # normalize=True loudness-scans each track as it opens (device
        # envelope, no PCM download — dsp/loudness.py) and offsets its
        # gain so tracks mastered at different levels match target_db
        self._normalize = normalize
        self._target_db = target_db
        self._levels: dict = {}        # track index -> (loudness, peak) dB
        self._offset_applied = 0.0     # the live track's offset
        self._i = 0
        self._player: Player | None = None
        self._metrics = Metrics()      # finished tracks' accumulated totals
        self.stopped = False

    # ------------------------------------------------------------- state
    @property
    def n_tracks(self) -> int:
        return len(self._paths)

    @property
    def current(self) -> int:
        return self._i

    @property
    def metrics(self) -> Metrics:
        """Session totals: every finished track plus the live one."""
        m = Metrics().merge(self._metrics)
        if self._player is not None:
            m.merge(self._player.metrics)
        return m

    @property
    def player(self) -> Player:
        """The current track's Player (opened on first touch)."""
        if self._player is None:
            off = 0.0
            if self._normalize:
                from ..config import get_active
                from ..dsp.loudness import (TARGET_DB,
                                            normalization_gain_db)
                # offsets are RELATIVE corrections on top of whatever
                # gain would otherwise apply — resolve the config
                # default so a zero offset and a 0.1 dB offset land on
                # the same base level; the clipping clamp bounds the
                # TOTAL (base + offset), so the offset is recomputed
                # from the cached (loudness, peak) under the live base
                base = (get_active().player.gain_db
                        if self._gain_db is None else self._gain_db)
                lv = self._levels.get(self._i)
                if lv is None:
                    from ..pipeline import track_levels
                    lv = track_levels(self._paths[self._i],
                                      device=self.device)
                    self._levels[self._i] = lv
                tgt = (TARGET_DB if self._target_db is None
                       else self._target_db)
                off = normalization_gain_db(lv[0], tgt, peak_db=lv[1],
                                            base_gain_db=base)
                gain = base + off
            else:
                # None keeps the Player on the config default gain
                gain = self._gain_db
            self._offset_applied = off
            self._player = Player(
                self._paths[self._i], sink=self.sink, gain_db=gain,
                eq_gains_db=self._eq_gains_db,
                apply_gapless=self._apply_gapless, speed=self._speed,
                device=self.device)
            fmt = (self._player.track.sample_rate,
                   self._player.track.channels)
            if self._fmt is None:
                self._fmt = fmt
            elif fmt != self._fmt:
                # refuse to splice incompatible PCM into one sink (a
                # WAV header fixes one rate/layout for the whole file)
                self._player = None
                raise ValueError(
                    f"track {self._i} is {fmt[0]} Hz/{fmt[1]}ch but the "
                    f"queue plays at {self._fmt[0]} Hz/{self._fmt[1]}ch; "
                    "queue tracks must share sample rate and channels")
        return self._player

    # --------------------------------------------------------------- api
    def play(self, tracks: int | None = None) -> int:
        """Play from the current position to the end of the queue (or
        `tracks` track-ends, whichever is first). Returns source samples
        advanced. stop() from a sink callback halts between pushes and
        keeps the position for resume, exactly like Player.play."""
        self.stopped = False
        emitted = 0
        remaining = len(self._paths) - self._i if tracks is None else tracks
        while remaining > 0 and not self.stopped:
            emitted += self.player.play()
            if self.player.stopped:
                self.stopped = True
                break
            remaining -= 1
            if self._i + 1 >= len(self._paths):
                break
            self._advance(self._i + 1)
        return emitted

    def next(self) -> bool:
        """Skip to the next track's start; False at the queue end."""
        if self._i + 1 >= len(self._paths):
            return False
        self._advance(self._i + 1)
        return True

    def prev(self) -> bool:
        """Back to the previous track's start; False at the first."""
        if self._i == 0:
            return False
        self._advance(self._i - 1)
        return True

    def seek(self, seconds: float):
        self.player.seek(seconds)

    def set_speed(self, speed: float):
        """Pitch-preserving tempo for the rest of the session (applies
        to the current track now and every later track as it opens)."""
        self._speed = speed
        if self._player is not None:
            self._player.set_speed(speed)

    def stop(self):
        self.stopped = True
        if self._player is not None:
            self._player.stop()

    def _advance(self, i: int):
        # carry live settings forward so mid-session changes persist
        # (the normalization offset is per-track: subtract it so the
        # USER gain is what carries, not this track's correction)
        if self._player is not None:
            self._gain_db = self._player.gain_db - self._offset_applied
            # carry verbatim: an explicit 1.0 must NOT revert the next
            # track to the config default speed
            self._speed = self._player.speed
            self._metrics.merge(self._player.metrics)
        self._i = i
        self._player = None

    # ------------------------------------------------- checkpoint/resume
    def snapshot(self) -> bytes:
        """Queue position + the current track's full session state."""
        import io

        import numpy as np
        buf = io.BytesIO()
        np.savez(buf, track=self._i, player=np.frombuffer(
            self.player.snapshot(), np.uint8))
        return buf.getvalue()

    def restore(self, blob: bytes):
        import io

        import numpy as np
        z = np.load(io.BytesIO(blob))
        # discard the live player WITHOUT _advance: restoring over an
        # in-progress queue must not merge the discarded playback into
        # the session metrics nor carry its gain/speed forward — the
        # snapshot defines the session state (ADVICE r3)
        self._player = None
        self._i = int(z["track"])
        self.player.restore(z["player"].tobytes())
