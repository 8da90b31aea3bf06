"""Replica supervisor: the fleet's self-healing tier.

Failover made replica death RECOVERABLE (registry liveness, breakers,
stream-resume failover) — but a dead replica stayed dead until a human
restarted it. ``ReplicaSupervisor`` owns N replica *slots*, each running
one serving subprocess, and closes the loop:

- **death detection, two ways**: the process EXITING (``proc.poll()``)
  and the process WEDGING — its registry heartbeat ages past the
  liveness window while the process is still alive (a hung event loop
  heartbeats nothing); a wedged replica is killed and treated as dead.
- **deterministic restart backoff**: a dead slot respawns after the
  shuffle/retry.py schedule (seeded, keyed by slot index — replayable
  chaos runs restart on identical schedules), and the attempt counter
  resets after ``serving.fleet.stableUptimeSeconds`` of healthy uptime.
- **crash-loop breaker**: ``serving.fleet.crashLoopThreshold`` deaths
  inside ``serving.fleet.crashLoopWindowSeconds`` stops the restart
  storm — the slot is marked DEGRADED (no further restarts, surfaced in
  ``fleet_stats()``, excluded from the autoscaler's healthy count)
  instead of burning CPU forever; ``reset_slot()`` re-arms it once the
  operator fixes the cause.
- **graceful retirement**: ``scale_down()`` routes through the
  drain path (SIGTERM → running queries finish, streams flush, registry
  entry retracted at exit) so a controller shrinking the fleet drops
  zero in-flight queries; an intentional stop is never counted as a
  death.

The spawn seam is injectable (``spawn(slot_index) -> replica process``)
so unit tests drive the state machine with fake processes and the
in-process chaos suite supervises real ``QueryServer`` instances; the
default spawns ``python -m spark_rapids_tpu_torch.serving.server`` and reads
its ``SERVING <host> <port>`` banner. Lock discipline: decisions happen
under the supervisor lock, process actions (spawn / kill / wait) happen
outside it (R006/R012).
"""
from __future__ import annotations

import enum
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.shuffle import retry
from spark_rapids_tpu_torch.shuffle.tcp import scan_registry
from spark_rapids_tpu_torch.utils import metrics as um


class SlotState(enum.Enum):
    STARTING = "STARTING"   # spawned, waiting for the address banner
    UP = "UP"               # process alive (and heartbeating, if registry)
    BACKOFF = "BACKOFF"     # died; restart scheduled on the retry schedule
    DEGRADED = "DEGRADED"   # crash-loop breaker fired: no more restarts
    DRAINING = "DRAINING"   # intentional retirement in progress
    STOPPED = "STOPPED"     # retired; slot kept for fleet_stats history


class _SubprocessReplica:
    """Default spawn product: one serving-server subprocess. ``addr`` is
    filled by a banner-reader thread once the child prints ``SERVING
    <host> <port>`` (stderr goes to DEVNULL — a chatty child must not
    fill an undrained pipe and wedge itself)."""

    def __init__(self, args: List[str]):
        self.proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        self.addr: Optional[str] = None
        threading.Thread(target=self._read_banner, daemon=True,
                         name="supervisor-banner").start()

    def _read_banner(self) -> None:
        try:
            for line in self.proc.stdout:
                parts = line.split()
                if len(parts) == 3 and parts[0] == "SERVING":
                    self.addr = f"{parts[1]}:{parts[2]}"
                    break
            # keep draining so the child never blocks on a full pipe
            for _line in self.proc.stdout:
                pass
        except (OSError, ValueError):
            pass

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self) -> None:
        try:
            self.proc.terminate()       # SIGTERM == graceful drain
        except OSError:
            pass

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass


class ReplicaSlot:
    """Supervisor-side state of one replica slot (all fields guarded by
    the supervisor lock except the spawned process's own attributes)."""

    __slots__ = ("index", "state", "proc", "started_at", "attempt",
                 "not_before", "deaths", "restarts", "stable_marked")

    def __init__(self, index: int):
        self.index = index
        self.state = SlotState.BACKOFF      # due for its initial spawn
        self.proc: Optional[Any] = None
        self.started_at = 0.0
        #: consecutive-death restart attempt (drives the backoff schedule;
        #: reset after stableUptimeSeconds of healthy uptime)
        self.attempt = 0
        #: monotonic time the next (re)spawn becomes due
        self.not_before = 0.0
        #: recent death times inside the crash-loop window
        self.deaths: deque = deque(maxlen=64)
        self.restarts = 0
        self.stable_marked = False

    @property
    def addr(self) -> Optional[str]:
        p = self.proc
        return getattr(p, "addr", None) if p is not None else None


class ReplicaSupervisor:
    """Spawns, watches, restarts and retires serving-replica slots."""

    def __init__(self, conf, spawn: Optional[Callable[[int], Any]] = None,
                 server_args: Optional[List[str]] = None):
        self.conf = conf
        self._spawn = spawn or self._default_spawn
        self._server_args = list(server_args or [])
        self._interval = conf.get(cfg.SERVING_FLEET_SUPERVISE_INTERVAL)
        self._backoff_ms = conf.get(cfg.SERVING_FLEET_RESTART_BACKOFF_MS)
        self._stable_s = conf.get(cfg.SERVING_FLEET_STABLE_UPTIME)
        self._crash_threshold = conf.get(cfg.SERVING_FLEET_CRASH_LOOP_THRESHOLD)
        self._crash_window = conf.get(cfg.SERVING_FLEET_CRASH_LOOP_WINDOW)
        self._seed = conf.get(cfg.SERVING_NET_FAULTS_SEED)
        self.registry_dir = conf.get(cfg.SERVING_NET_REGISTRY)
        self._liveness_window = conf.get(cfg.SERVING_HEALTH_LIVENESS_WINDOW)
        self._lock = threading.Lock()
        self._slots: Dict[int, ReplicaSlot] = {}
        self._next_index = 0
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- spawning ----------------------------------------------------------
    def _default_spawn(self, slot_index: int) -> _SubprocessReplica:
        args = [sys.executable, "-m", "spark_rapids_tpu_torch.serving.server",
                "--port", "0"]
        for key, val in sorted(getattr(self.conf, "_values", {}).items()):
            if isinstance(val, bool):
                val = "true" if val else "false"
            args += ["--conf", f"{key}={val}"]
        args += self._server_args
        return _SubprocessReplica(args)

    # ---- lifecycle ---------------------------------------------------------
    def start(self, replicas: int) -> None:
        """Create ``replicas`` slots (spawned by the first tick) and start
        the supervision loop thread."""
        with self._lock:
            for _ in range(max(0, replicas)):
                self._new_slot_locked()
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="replica-supervisor")
            self._thread.start()
        self.tick()

    def _new_slot_locked(self) -> ReplicaSlot:
        slot = ReplicaSlot(self._next_index)
        self._next_index += 1
        self._slots[slot.index] = slot
        return slot

    def _loop(self) -> None:
        # Event.wait is the bounded sleep (R010); tick() itself holds the
        # lock only while deciding, never across a spawn/kill (R006)
        while not self._stop_event.wait(self._interval):
            self.tick()

    def stop(self, graceful: bool = False, timeout: float = 10.0) -> None:
        """Stop supervising and stop every replica. ``graceful`` drains
        each (terminate = the SIGTERM drain path) and waits out the
        timeout before killing what's left; otherwise kill outright."""
        self._stop_event.set()
        with self._lock:
            procs = [s.proc for s in self._slots.values()
                     if s.proc is not None]
            for s in self._slots.values():
                s.state = SlotState.STOPPED
        for p in procs:
            (p.terminate if graceful else p.kill)()
        if graceful:
            deadline = time.monotonic() + timeout
            for p in procs:
                while p.poll() is None and time.monotonic() < deadline:
                    time.sleep(0.05)
                if p.poll() is None:
                    p.kill()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    # ---- the supervision tick ----------------------------------------------
    def tick(self) -> None:
        """One supervision pass: reap exits, kill wedged replicas (missed
        heartbeats), schedule/execute restarts, fire the crash-loop
        breaker. Public so unit tests drive the state machine without the
        loop thread."""
        live_addrs = self._live_registry_addrs()    # blocking IO: no lock
        now = time.monotonic()
        to_kill: List[Any] = []
        to_spawn: List[ReplicaSlot] = []
        with self._lock:
            for slot in self._slots.values():
                if slot.state in (SlotState.DEGRADED, SlotState.STOPPED):
                    continue
                if slot.state is SlotState.DRAINING:
                    if slot.proc is None or slot.proc.poll() is not None:
                        slot.state = SlotState.STOPPED
                        slot.proc = None
                    continue
                if slot.state is SlotState.BACKOFF:
                    if now >= slot.not_before:
                        # claim the slot under the lock BEFORE the
                        # out-of-lock spawn: a concurrent tick must not
                        # collect it again and double-spawn
                        slot.state = SlotState.STARTING
                        to_spawn.append(slot)
                    continue
                proc = slot.proc
                if proc is None:
                    continue
                if proc.poll() is not None:         # death by exit
                    self._record_death_locked(slot, now)
                    continue
                if slot.state is SlotState.STARTING and slot.addr:
                    slot.state = SlotState.UP
                if (not slot.stable_marked
                        and now - slot.started_at >= self._stable_s):
                    slot.attempt = 0                # earned a fresh schedule
                    slot.stable_marked = True
                if self._wedged_locked(slot, live_addrs, now):
                    # death by silence: alive but not heartbeating — kill
                    # the wedged process and restart it like any death
                    to_kill.append(proc)
                    self._record_death_locked(slot, now)
        for proc in to_kill:
            proc.kill()
        for slot in to_spawn:
            self._respawn(slot)

    def _live_registry_addrs(self) -> Optional[set]:
        """Addresses with a fresh heartbeat; None when heartbeat-based
        death detection is off (no registry) or the scan failed RIGHT NOW
        (transient FS hiccup — a missed scan must not read as a massacre)."""
        if not self.registry_dir:
            return None
        try:
            return set(scan_registry(self.registry_dir,
                                     stale_after_s=self._liveness_window)
                       .values())
        except OSError:
            return None

    def _wedged_locked(self, slot: ReplicaSlot, live_addrs: Optional[set],
                       now: float) -> bool:
        if live_addrs is None or slot.state is not SlotState.UP:
            return False
        addr = slot.addr
        if addr is None:
            return False
        # grace: a replica younger than the liveness window may simply
        # not have published its first heartbeat yet
        if now - slot.started_at <= self._liveness_window:
            return False
        return addr not in live_addrs

    def _record_death_locked(self, slot: ReplicaSlot, now: float) -> None:
        slot.proc = None
        slot.deaths.append(now)
        while slot.deaths and slot.deaths[0] < now - self._crash_window:
            slot.deaths.popleft()
        if len(slot.deaths) >= self._crash_threshold:
            # crash-loop breaker: N rapid deaths — stop restarting,
            # surface the slot instead of burning CPU forever
            slot.state = SlotState.DEGRADED
            return
        slot.attempt += 1
        slot.stable_marked = False
        delay_ms = retry.backoff_ms(slot.attempt - 1, self._backoff_ms,
                                    self._seed,
                                    key=f"supervisor:slot{slot.index}")
        slot.state = SlotState.BACKOFF
        slot.not_before = now + delay_ms / 1e3

    def _respawn(self, slot: ReplicaSlot) -> None:
        """Spawn a replica into a slot already claimed for it (state
        STARTING, proc None — set under the lock by tick()/scale_up()
        before this out-of-lock call, so no two spawns target one slot)."""
        try:
            proc = self._spawn(slot.index)  # blocking: outside the lock
        except Exception:
            with self._lock:    # a failed spawn retries on the schedule
                if slot.state is SlotState.STARTING and slot.proc is None:
                    self._record_death_locked(slot, time.monotonic())
            return
        with self._lock:
            claimed = (slot.state is SlotState.STARTING
                       and slot.proc is None)
            if not claimed:
                stale = proc    # raced a stop()/retire: don't leak it
            else:
                stale = None
                #: a spawn that follows a death is a restart; the very
                #: first spawn (and a reset_slot re-arm) is not
                is_restart = slot.attempt > 0
                slot.proc = proc
                slot.started_at = time.monotonic()
                slot.stable_marked = False
                slot.state = (SlotState.UP if slot.addr
                              else SlotState.STARTING)
                if is_restart:
                    slot.restarts += 1
        if stale is not None:
            stale.kill()
            return
        if is_restart:
            um.SERVING_METRICS[um.SERVING_RESTARTS].add(1)

    # ---- fleet control (the autoscaler's levers) ---------------------------
    def scale_up(self) -> int:
        """Add one slot and spawn it now; returns the slot index."""
        with self._lock:
            slot = self._new_slot_locked()
            slot.state = SlotState.STARTING     # claimed for _respawn
        self._respawn(slot)
        return slot.index

    def scale_down(self, addr: Optional[str] = None) -> Optional[int]:
        """Retire one replica through the graceful-drain path: terminate()
        is the SIGTERM drain contract — running queries finish, streams
        flush, the registry entry is retracted at exit — and an
        intentionally DRAINING slot is never counted as a death. Prefers
        the replica at ``addr``; falls back to the newest active slot.
        Returns the retired slot index, or None when nothing matched."""
        with self._lock:
            candidates = [s for s in self._slots.values()
                          if s.state in (SlotState.UP, SlotState.STARTING)]
            chosen = None
            if addr is not None:
                chosen = next((s for s in candidates if s.addr == addr),
                              None)
            if chosen is None and addr is None and candidates:
                chosen = max(candidates, key=lambda s: s.index)
            if chosen is None:
                return None
            chosen.state = SlotState.DRAINING
            proc = chosen.proc
        if proc is not None:
            proc.terminate()
        return chosen.index

    def reset_slot(self, index: int) -> bool:
        """Re-arm a DEGRADED slot (the operator fixed the crash cause):
        clears the breaker history and schedules an immediate respawn."""
        with self._lock:
            slot = self._slots.get(index)
            if slot is None or slot.state is not SlotState.DEGRADED:
                return False
            slot.deaths.clear()
            slot.attempt = 0
            slot.state = SlotState.BACKOFF
            slot.not_before = 0.0
        return True

    # ---- introspection -----------------------------------------------------
    def addresses(self) -> List[str]:
        """Addresses of slots whose replica is (or is coming) up."""
        with self._lock:
            return [s.addr for s in self._slots.values()
                    if s.state in (SlotState.UP, SlotState.STARTING)
                    and s.addr]

    def active_count(self) -> int:
        """Slots the fleet can count on: UP/STARTING/BACKOFF (a slot in
        backoff is coming back; a DEGRADED or retired one is not)."""
        with self._lock:
            return sum(1 for s in self._slots.values()
                       if s.state in (SlotState.UP, SlotState.STARTING,
                                      SlotState.BACKOFF))

    def degraded_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values()
                       if s.state is SlotState.DEGRADED)

    def fleet_stats(self) -> Dict[str, Any]:
        """The supervisor's surface in serve.stats / CI assertions: every
        slot's state, address, restart count and recent-death count —
        DEGRADED (crash-looping) slots included, that is the point."""
        with self._lock:
            slots = [{"index": s.index, "state": s.state.value,
                      "addr": s.addr, "restarts": s.restarts,
                      "recent_deaths": len(s.deaths),
                      "attempt": s.attempt} for s in self._slots.values()]
        counts: Dict[str, int] = {}
        for s in slots:
            counts[s["state"]] = counts.get(s["state"], 0) + 1
        return {"slots": slots, "states": counts,
                "active": sum(1 for s in slots
                              if s["state"] in ("UP", "STARTING", "BACKOFF")),
                "degraded": counts.get("DEGRADED", 0)}
