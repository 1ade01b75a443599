"""Server->client AIMD frame-rate control.

The escalation ladder for overload is: adaptive resolution downshift
(engine, dispatch lane, tpu.adaptive_slo_ms) -> frame shedding (bounded
per-client queues) -> THIS: tell clients to capture less. The reference
declared the wire vehicle (CommandType/CONFIG_UPDATE, types.h:81) but never
defined a body or handler; the rebuild already gave CONFIG_UPDATE a JSON
body client->server (protocol/packets.py ConfigUpdatePacket) — this module
drives it the other direction, so well-behaved clients shape their offered
load instead of having it randomly shed.

Pure decision logic, no I/O: DetectionServer calls tick() from its monitor
loop (5 s cadence) and broadcasts whatever fps this returns. AIMD shape:

- overload signal: detect p99 > slo OR sustained shedding (drop_frac —
  dropped/offered over the stats window — above `drop_frac_slo`). The p99
  alone is blind to the exact mode this feature targets: shed frames never
  produce a result, so they contribute NO latency sample; a server
  steady-state shedding half its offered load can report a healthy p99.
  The drop signal carries a LATCH: if cutting all the way to the floor
  leaves the fraction high while p99 stays healthy for `floor_probe_ticks`
  ticks, the sheds evidently do not respond to client rate (a
  hint-ignoring or misbehaving sender — the caller already excludes
  oversized-frame sheds at the source) — the drop signal disarms and p99
  alone governs until the fraction clears the recovery band once.
- decrease: overloaded  ->  hint = max(min_fps, 0.8 x current per-client
  rate), at most once per `decrease_cooldown` ticks (the rolling-p99
  window lags the load change; back-to-back cuts would overshoot to the
  floor before the first cut is even measurable).
- hold: under the SLO but above the 70% recovery band with a hint active
  -> re-broadcast (UDP delivery is best-effort; periodic re-send is the
  loss story).
- increase: p99 < 0.7 x slo and drops < 0.7 x drop_frac_slo -> hint grows
  10% (>=1 fps) per tick; reaching the configured target restores
  uncontrolled operation. The full-rate restore is re-broadcast for
  `restore_ticks` healthy ticks before the controller stands down — a
  single unACKed CONFIG_UPDATE datagram must not be able to strand a
  client at its last throttled rate forever.
"""

from __future__ import annotations

from typing import Optional


class RateController:
    """AIMD controller over the monitor-tick cadence. Not thread-safe by
    design: exactly one caller (the monitor loop) ticks it."""

    def __init__(self, slo_ms: float, min_fps: int, target_fps: float,
                 decrease: float = 0.8, increase_frac: float = 0.1,
                 recover_frac: float = 0.7, decrease_cooldown: int = 2,
                 drop_frac_slo: float = 0.05, restore_ticks: int = 3,
                 floor_probe_ticks: int = 6):
        self.slo_ms = float(slo_ms)
        self.min_fps = max(int(min_fps), 1)
        self.target_fps = max(float(target_fps), float(self.min_fps))
        self.decrease = decrease
        self.increase_frac = increase_frac
        self.recover_frac = recover_frac
        self.decrease_cooldown = max(int(decrease_cooldown), 1)
        self.drop_frac_slo = float(drop_frac_slo)
        self.restore_ticks = max(int(restore_ticks), 0)
        self.floor_probe_ticks = max(int(floor_probe_ticks), 1)
        self.hint: Optional[int] = None
        self._tick = 0
        self._last_decrease = -10 ** 9
        self._restore_left = 0
        self._floor_ticks = 0
        # Drop-signal latch: cuts all the way to the floor that leave the
        # drop fraction high while p99 stays healthy mean the sheds do not
        # respond to client rate (a hint-ignoring or misbehaving sender).
        # The signal then disarms — p99 alone governs — until the fraction
        # clears the recovery band once (fresh information re-arms it).
        # Without this, one bad client pins every well-behaved one at
        # min_fps forever: its drops are invariant under everyone's cuts.
        self._drop_armed = True

    def tick(self, p99_ms: Optional[float],
             per_client_rx_fps: Optional[float],
             drop_frac: float = 0.0) -> Optional[int]:
        """One monitor-cadence decision. Returns the fps to broadcast this
        tick (None = send nothing). `per_client_rx_fps` is the measured
        ingest rate per client, used to seed the first decrease — cutting
        from the *actual* offered rate instead of the configured target
        reaches a sustainable hint in one step when clients already stream
        slower than configured. `drop_frac` is dropped/offered over the
        stats window: shed frames produce no latency sample, so it is the
        only signal in the shed-dominated overload mode."""
        self._tick += 1
        if self.slo_ms <= 0:
            return None
        p99 = float(p99_ms or 0.0)
        drops = float(drop_frac or 0.0)
        p99_healthy = p99 < self.recover_frac * self.slo_ms
        drops_healthy = drops < self.recover_frac * self.drop_frac_slo
        if drops_healthy:
            self._drop_armed = True  # cleared once: future rises are real
        lat_over = p99 > self.slo_ms
        drop_over = self._drop_armed and drops > self.drop_frac_slo
        if lat_over or drop_over:
            self._restore_left = 0
            if (not lat_over and p99_healthy and self.hint == self.min_fps):
                # Drop-only overload, already at the floor, p99 healthy:
                # count toward the latch (see __init__) instead of holding
                # the floor forever.
                self._floor_ticks += 1
                if self._floor_ticks < self.floor_probe_ticks:
                    return self.hint
                self._drop_armed = False
                self._floor_ticks = 0
                # Fall through to the recovery path below this tick.
            else:
                self._floor_ticks = 0
                if (self.hint is not None and self._tick - self._last_decrease
                        < self.decrease_cooldown):
                    return self.hint  # cooldown: hold, keep re-broadcasting
                base = float(self.hint) if self.hint is not None else (
                    per_client_rx_fps
                    if per_client_rx_fps and per_client_rx_fps > 0
                    else self.target_fps)
                # Clamp UNDER target_fps: a measured rx above the target
                # (bursting client) must not seed a "throttle" hint that
                # RAISES everyone's rate during overload.
                self.hint = max(self.min_fps,
                                min(int(base * self.decrease),
                                    int(self.target_fps) - 1))
                self._last_decrease = self._tick
                return self.hint
        else:
            self._floor_ticks = 0
        if self.hint is None:
            if self._restore_left > 0:
                # Post-recovery: keep re-broadcasting the full rate — the
                # restore rung needs the same datagram-loss story as
                # hold/decrease or one lost packet throttles a client forever.
                self._restore_left -= 1
                return int(self.target_fps)
            return None
        if p99_healthy and (drops_healthy or not self._drop_armed):
            nxt = self.hint + max(1, int(self.hint * self.increase_frac))
            if nxt >= self.target_fps:
                self.hint = None  # restored: uncontrolled operation
                self._restore_left = self.restore_ticks
                return int(self.target_fps)
            self.hint = nxt
        return self.hint
