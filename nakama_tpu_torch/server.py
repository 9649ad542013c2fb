"""Server assembly: component wiring in dependency order + lifecycle.

Parity with the reference main() (reference main.go:64-282) for the
components the port has: metrics → session registry/caches → tracker →
router → match registry → matchmaker (`CudaBackend` on the card) →
recovery plane → tracing and device telemetry → overload plane → party
registry → channels, notifications, wallets, friends and groups →
purchases and the Google refund scheduler → pipeline → socket acceptor
→ the social client → leaderboards (the `DeviceRankEngine` on the
matchmaker's device) → API server → console, the runtime's Python, Lua
and JS modules loaded at `start()` (`runtime.path`, or
`runtime_modules`) and attached to the pipeline, the API, the matched
handler, the match registry, the socket's session events, the
leaderboard and refund schedulers — and graceful shutdown in reverse,
ending with drain-to-durable. The database is the engine that
`database.address` names: SQLite (a file or `:memory:`) or Postgres (a
`postgres://` DSN, `storage/pg.py`). The port's copy of the JAX
package's `server.py`; the cluster of the JAX server comes with its own
slice (ROADMAP.md §A). The console is the second listener, on
`console.port` (0 when `socket.port` is 0), and the gRPC front door
(`api/grpc_server.py`) the third, on `socket.grpc_port`, as in the JAX
server.
"""

from __future__ import annotations

import asyncio
import signal

from .api.matchmaker_events import make_matched_handler
from .api.pipeline import Components, Pipeline
from .api.socket import SocketAcceptor
from .config import Config, apply_observability, parse_args
from .core.channel import Channels
from .core.friend import Friends
from .core.group import Groups
from .core.notification import Notifications
from .core.purchase import Purchases
from .core.wallet import Wallets
from .iap.refund import GoogleRefundScheduler
from .logger import Logger, set_node_name, setup_logging
from .match import LocalMatchRegistry, LocalPartyRegistry
from .matchmaker import LocalMatchmaker
from .metrics import Metrics
from .realtime import (
    LocalLoginAttemptCache,
    LocalMessageRouter,
    LocalSessionCache,
    LocalSessionRegistry,
    LocalStatusRegistry,
    LocalStreamManager,
    LocalTracker,
    StreamMode,
)


class NakamaServer:
    def __init__(
        self,
        config: Config,
        logger: Logger | None = None,
        matchmaker_backend=None,
        runtime_modules: list | None = None,
    ):
        """`matchmaker_backend=None` builds the backend that
        `config.matchmaker.backend` names: "cuda" (the default) is
        `CudaBackend` on cuda:0 and raises here when there is no CUDA
        device; "cpu" is the host oracle. `runtime_modules`: init_module
        callables (or (name, callable) pairs) loaded at `start()` before
        the modules of `config.runtime.path`."""
        self.config = config
        self._runtime_modules = runtime_modules or []
        self.runtime = None
        self.logger = logger or setup_logging(config.logger)
        log = self.logger
        node = config.name
        # Fleet log attribution: every record this process emits
        # carries the node name next to its trace ids (logger.py).
        set_node_name(node)

        # Persistence (reference DbConnect, main.go:129-133): constructed
        # here, connected in start().
        from .storage import make_database

        dc = config.database
        self.db = make_database(
            dc.address or [":memory:"],
            read_pool_size=min(dc.read_pool_size, dc.max_open_conns),
            write_batch_max=dc.write_batch_max,
            write_queue_depth=dc.write_queue_depth,
            write_drain_deadline_ms=dc.write_drain_deadline_ms,
            db_drain_restart_max=dc.db_drain_restart_max,
        )
        self._db_connected = False

        metrics_cfg = config.metrics
        self.metrics = Metrics(metrics_cfg.namespace)
        # Fault plane observability: injections delivered by armed
        # points surface as `faults_injected` on this server's registry.
        from . import faults

        faults.PLANE.bind_metrics(self.metrics)
        self.session_registry = LocalSessionRegistry(log, self.metrics)
        self.tracker = LocalTracker(
            log, node, self.metrics, config.tracker.event_queue_size
        )
        self.router = LocalMessageRouter(
            log, self.session_registry, self.tracker, self.metrics
        )
        self.session_cache = LocalSessionCache(
            config.session.token_expiry_sec,
            config.session.refresh_token_expiry_sec,
        )
        self.login_attempt_cache = LocalLoginAttemptCache()
        self.tracker.set_event_router(self.router.route_presence_event)
        self.status_registry = LocalStatusRegistry(log, self.session_registry)
        self.tracker.add_listener(
            StreamMode.STATUS, self.status_registry.status_listener()
        )
        self.stream_manager = LocalStreamManager(
            log, self.session_registry, self.tracker
        )
        self.match_registry = LocalMatchRegistry(
            log, config.match, self.router, node, self.metrics,
            tracker=self.tracker,
        )
        self.tracker.add_listener(
            StreamMode.MATCH_AUTHORITATIVE, self.match_registry.join_listener()
        )
        self.matchmaker = LocalMatchmaker(
            log,
            config.matchmaker,
            self.metrics,
            node,
            backend=matchmaker_backend,
        )
        # Group-commit batch size / queue depth / commit counter become
        # scrapeable, and drain spans land in the matchmaker backend's
        # Tracing ledger, next to the interval breadcrumbs.
        self.db.bind_observability(
            metrics=self.metrics,
            tracing=getattr(self.matchmaker.backend, "tracing", None),
        )
        # Crash-recovery plane (recovery.py): attaches the durable
        # ticket journal + idle-gap checkpointer to the matchmaker;
        # start() runs the warm restart once the engine is connected,
        # stop() drains to durable (journal flush + final checkpoint).
        self.recovery = None
        if config.recovery.enabled:
            from .recovery import RecoveryPlane

            self.recovery = RecoveryPlane(
                config.recovery,
                self.db,
                self.matchmaker,
                log,
                metrics=self.metrics,
                node=node,
                data_dir=config.data_dir,
            )
        # Request-scoped tracing + SLO plane and the device telemetry
        # plane: process-wide stores, configured from this server's
        # config and bound to its registry (the last server constructed
        # owns them).
        self.slo = apply_observability(
            config.tracing,
            config.devobs,
            metrics=self.metrics,
            logger=log.with_fields(subsystem="devobs"),
        )
        self.matchmaker.slo = self.slo

        # Overload-control plane (overload.py): built here so the API
        # server and pipeline can reference it; signals are registered
        # and the ladder sampler started in start() once the components
        # they read exist. `overload.enabled=False` leaves the front
        # doors unwired (no admission, no deadlines).
        from . import overload as overload_mod
        from .tracing import Tracing

        self.overload = None
        self._overload_tracing = getattr(
            self.matchmaker.backend, "tracing", None
        ) or Tracing(logger=log)
        if config.overload.enabled:
            oc = config.overload
            admission = overload_mod.AdmissionController(
                oc.admission_max_concurrent,
                {
                    overload_mod.REALTIME: oc.admission_queue_realtime,
                    overload_mod.RPC: oc.admission_queue_rpc,
                    overload_mod.LIST: oc.admission_queue_list,
                },
                retry_after_sec=oc.retry_after_sec,
                metrics=self.metrics,
            )
            limiter = (
                overload_mod.RateLimiter(
                    oc.rate_limit_rps, oc.rate_limit_burst
                )
                if oc.rate_limit_rps > 0
                else None
            )
            self.overload = overload_mod.OverloadController(
                admission,
                limiter,
                recover_samples=oc.ladder_recover_samples,
                logger=log.with_fields(subsystem="overload"),
                metrics=self.metrics,
                tracing=self._overload_tracing,
            )
        self.matchmaker.on_matched = make_matched_handler(
            log,
            self.router,
            node,
            config.session.encryption_key,
        )
        self.party_registry = LocalPartyRegistry(
            log, self.tracker, self.router, self.matchmaker, node
        )
        self.tracker.add_listener(
            StreamMode.PARTY, self.party_registry.join_listener()
        )
        self.channels = Channels(log, self.db, self.router)
        self.notifications = Notifications(log, self.db, self.router)
        self.wallets = Wallets(log, self.db)
        self.friends = Friends(log, self.db, self.notifications)
        self.groups = Groups(log, self.db)
        self.purchases = Purchases(log, self.db, config)
        self.google_refund_scheduler = GoogleRefundScheduler(
            log,
            self.db,
            config,
            poll_interval_sec=config.iap.google_refund_poll_sec,
        )
        # Production social verifier (reference social.NewClient,
        # main.go:136); per-provider config rides each call. Tests may
        # substitute a StubSocialClient.
        from .social.client import HttpSocialClient

        self.social = HttpSocialClient()
        self._build_leaderboards(config, log)
        self.pipeline = Pipeline(
            log,
            Components(
                config=config,
                tracker=self.tracker,
                router=self.router,
                status_registry=self.status_registry,
                matchmaker=self.matchmaker,
                match_registry=self.match_registry,
                party_registry=self.party_registry,
                session_registry=self.session_registry,
                channels=self.channels,
                groups=self.groups,
                db=self.db,
                metrics=self.metrics,
                overload=self.overload,
            ),
        )
        self.acceptor = SocketAcceptor(
            config,
            log,
            self.session_registry,
            self.session_cache,
            self.tracker,
            self.status_registry,
            self.pipeline,
            self.metrics,
            matchmaker=self.matchmaker,
            held=None if self.recovery is None else self.recovery.held,
        )
        from .api.http import ApiServer
        from .console import ConsoleServer

        self.api = ApiServer(self)
        self.console = ConsoleServer(self)
        self.port: int | None = None
        self.console_port: int | None = None
        # The gRPC front door (api/grpc_server.py), started after the
        # console unless `socket.grpc_port` is -1.
        self.grpc = None
        self.grpc_port: int | None = None
        self.metrics_port: int | None = None
        self.recovered: dict | None = None
        self._release_held: asyncio.TimerHandle | None = None

    def _build_leaderboards(self, config: Config, log: Logger) -> None:
        """Leaderboards over the host rank cache (the oracle) and, with
        `leaderboard.device_enabled`, the `DeviceRankEngine` on the
        matchmaker backend's device: cuda:0 under `CudaBackend` (the
        default), the host when the backend runs there (the host oracle
        of `matchmaker.backend cpu`, a `CudaBackend(device="cpu")`)."""
        from .leaderboard import (
            DeviceRankEngine,
            LeaderboardScheduler,
            Leaderboards,
            Tournaments,
            rank_cache_from_config,
        )

        lb_rank_cache = rank_cache_from_config(config.leaderboard)
        lb_device = None
        if config.leaderboard.device_enabled:
            lb_device = DeviceRankEngine(
                config.leaderboard,
                log,
                metrics=self.metrics,
                oracle=lb_rank_cache,
                device=getattr(self.matchmaker.backend, "device", "cpu"),
            )
        self.leaderboards = Leaderboards(
            log, self.db, lb_rank_cache, device_engine=lb_device
        )
        if self.recovery is not None:
            # Board columns ride the checkpoint: staged keys (seq
            # included) snapshot with the pool and restore before
            # load()'s DB re-inserts, preserving tie-break order across
            # a warm restart.
            self.recovery.checkpointer.rank_engine = lb_device
        self.tournaments = Tournaments(self.leaderboards)
        # The runtime's reset and end hooks attach at start().
        self.leaderboard_scheduler = LeaderboardScheduler(
            log, self.leaderboards, self.tournaments, runtime=None
        )
        self.leaderboards.on_change = self.leaderboard_scheduler.update

    def attach_runtime(self, runtime):
        """Wire the extensibility runtime into the pipeline, the matchmaker
        matched hook, the match registry (named match factories), and the
        session start/end events (reference NewRuntime wiring,
        main.go:155-160; session_ws.go Close path)."""
        self.runtime = runtime
        self.pipeline.c.runtime = runtime
        self.matchmaker.on_matched = make_matched_handler(
            self.logger,
            self.router,
            self.config.name,
            self.config.session.encryption_key,
            runtime=runtime,
        )
        override = getattr(runtime, "matchmaker_override", None)
        if override is not None and override() is not None:
            self.matchmaker.override_fn = override()
        match_names = getattr(runtime, "match_names", None)
        if match_names is not None:
            for name in match_names():
                self.match_registry.register(
                    name, runtime.match_factory(name)
                )
        fire_start = getattr(runtime, "fire_session_start", None)
        if fire_start is not None:
            self.acceptor.on_session_start = fire_start
            self.acceptor.on_session_end = runtime.fire_session_end
        self.leaderboard_scheduler.runtime = runtime

    def _load_runtime(self):
        from .runtime import load_runtime

        return load_runtime(
            self.logger,
            self.config,
            modules=self._runtime_modules,
            db=self.db,
            session_cache=self.session_cache,
            session_registry=self.session_registry,
            tracker=self.tracker,
            router=self.router,
            stream_manager=self.stream_manager,
            status_registry=self.status_registry,
            matchmaker=self.matchmaker,
            match_registry=self.match_registry,
            party_registry=self.party_registry,
            metrics=self.metrics,
            leaderboards=self.leaderboards,
            tournaments=self.tournaments,
            channels=self.channels,
            friends=self.friends,
            groups=self.groups,
            notifications=self.notifications,
            wallet=self.wallets,
            purchases=self.purchases,
            social=self.social,
        )

    # ------------------------------------------------------------ lifecycle

    async def start(self):
        # Match tasks always land on this loop, even when create_match is
        # driven from a guest-module worker thread.
        self.match_registry.loop = asyncio.get_running_loop()
        if not self._db_connected:
            await self.db.connect()
            self._db_connected = True
        if self.recovery is not None:
            # Warm restart BEFORE the matchmaker starts ticking: rebuild
            # the host pool + device buffers from snapshot and replay
            # the journal tail, so tickets stranded by a crash are
            # matchable again from the first interval.
            recovered = await self.recovery.recover()
            self.recovered = recovered
            # The tickets the last graceful stop kept for its players
            # leave the pool until their players return, for as long as
            # they would have stayed active in it.
            mm_cfg = self.config.matchmaker
            held = self.recovery.held.load(
                mm_cfg.max_intervals * mm_cfg.interval_sec
            )
            rc = self.config.recovery
            self.logger.info(
                "crash recovery enabled",
                journal=rc.journal,
                checkpoint_interval_sec=rc.checkpoint_interval_sec,
                checkpoint_path=self.recovery.path,
                recovered_tickets=recovered["tickets"],
                replayed_rows=recovered["replayed_rows"],
                held_tickets=held,
                recovery_ms=round(recovered["duration_s"] * 1000, 1),
            )
        if self.runtime is None and (
            self._runtime_modules or self.config.runtime.path
        ):
            self.attach_runtime(self._load_runtime())
        if self.runtime is not None:
            self.runtime.start_events()
        await self.leaderboards.load()
        self.leaderboard_scheduler.start()
        self.google_refund_scheduler.runtime = self.runtime
        self.google_refund_scheduler.start()
        self.tracker.start()
        self.matchmaker.start()
        if self.recovery is not None and len(self.recovery.held):
            self._release_held = asyncio.get_running_loop().call_later(
                self.recovery.held.remaining_s(),
                self.recovery.held.release,
            )
        if self.overload is not None:
            # Ladder signals read components that now exist: storage
            # write-queue depth, the device backend's breaker, matchmaker
            # delivery lag and the SLO burn.
            from . import overload as overload_mod

            oc = self.config.overload
            batcher = self.db._batcher
            self.overload.register_signal(
                "db_write_queue_depth",
                overload_mod.db_queue_signal(
                    lambda: batcher.depth,
                    self.config.database.write_queue_depth,
                    oc.shed_queue_depth_warn,
                    oc.shed_queue_depth_shed,
                ),
            )
            if getattr(self.matchmaker.backend, "breaker", None) is not None:
                self.overload.register_signal(
                    "backend_breaker",
                    overload_mod.breaker_signal(
                        lambda: getattr(
                            self.matchmaker.backend, "breaker", None
                        )
                    ),
                )
            self.overload.register_signal(
                "matchmaker_interval_lag",
                overload_mod.interval_lag_signal(
                    self.matchmaker._next_cohort_deadline,
                    oc.interval_lag_warn_sec,
                    oc.interval_lag_shed_sec,
                ),
            )
            if self.slo is not None:
                tc = self.config.tracing
                self.overload.register_signal(
                    "slo_burn",
                    overload_mod.slo_burn_signal(
                        self.slo,
                        tc.slo_burn_warn,
                        tc.slo_burn_shed,
                        escalate=tc.slo_overload_feedback,
                    ),
                )
            self.overload.start(max(50, oc.ladder_sample_ms) / 1000.0)
            self.logger.info(
                "overload control enabled",
                max_concurrent=oc.admission_max_concurrent,
                queues=dict(
                    realtime=oc.admission_queue_realtime,
                    rpc=oc.admission_queue_rpc,
                    list=oc.admission_queue_list,
                ),
                deadline_default_ms=oc.deadline_default_ms,
                deadline_realtime_ms=oc.deadline_realtime_ms,
                rate_limit_rps=oc.rate_limit_rps,
                rate_limit_burst=oc.rate_limit_burst,
                ladder_sample_ms=oc.ladder_sample_ms,
                ladder_recover_samples=oc.ladder_recover_samples,
            )
        tc = self.config.tracing
        if tc.enabled:
            self.logger.info(
                "tracing enabled",
                sample_rate=tc.sample_rate,
                slow_trace_ms=tc.slow_trace_ms,
                capacity=tc.capacity,
                export_path=tc.export_path or None,
                slo_target=tc.slo_target,
                slo_overload_feedback=tc.slo_overload_feedback,
            )
        dv = self.config.devobs
        if dv.enabled:
            self.logger.info(
                "device telemetry enabled",
                warmup_intervals=dv.warmup_intervals,
                timeline_depth=dv.timeline_depth,
            )
        mm_cfg = self.config.matchmaker
        if mm_cfg.interval_pipelining:
            self.logger.info(
                "matchmaker delivery stage started",
                event_driven=True,
                watchdog_sec=float(mm_cfg.delivery_watchdog_sec),
                deadline_guard_sec=float(mm_cfg.pipeline_deadline_guard_sec),
            )
        # One port serves the REST API and /ws (reference api.go: the
        # gateway HTTP listener owns both on the main port).
        self.port = await self.api.start(
            self.config.socket.address or "127.0.0.1",
            self.config.socket.port,
        )
        self.metrics_port = self.api.metrics_port
        # Second listener for operators (reference StartConsoleServer,
        # console.go:167); port 0 when the API's is.
        self.console_port = await self.console.start(
            self.config.console.address or "127.0.0.1",
            0 if self.config.socket.port == 0 else self.config.console.port,
        )
        # gRPC front door: the NakamaApi service transcoding onto the REST
        # listener (api/grpc_server.py; reference convention puts gRPC on
        # port-1 = 7349 next to HTTP 7350 — port 0 when the API's is).
        if self.config.socket.grpc_port >= 0:
            from .api.grpc_server import GrpcGateway

            # The loopback targets the address the REST listener bound.
            self.grpc = GrpcGateway(
                self.logger,
                self.config.socket.address or "127.0.0.1",
                self.port,
            )
            self.grpc_port = await self.grpc.start(
                self.config.socket.address or "127.0.0.1",
                0 if self.config.socket.port == 0
                else self.config.socket.grpc_port or self.port - 1,
            )
        self.logger.info(
            "server listening",
            port=self.port,
            console=self.console_port,
            grpc=self.grpc_port,
            metrics=self.metrics_port,
            backend=type(self.matchmaker.backend).__name__,
            device=str(getattr(self.matchmaker.backend, "device", "cpu")),
        )

    async def stop(self):
        """Reverse-order shutdown, then DRAIN-TO-DURABLE (recovery.py):
        the overload ladder walks to SHED so no new low-priority work is
        admitted, in-flight matchmaker cohorts get the grace window to
        publish, sessions close with a structured restart code +
        Retry-After hint (their tickets are held for their return,
        recovery.HeldTickets), the ticket
        journal flushes and a final checkpoint lands, and the storage
        write queue COMMITS before close() — a clean SIGTERM loses
        neither tickets nor acknowledged writes."""
        grace = self.config.shutdown_grace_sec
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(0, grace)
        if self.overload is not None:
            # Drain posture FIRST: reject new queue-able work with
            # Retry-After while the front doors finish in-flight
            # requests — the crash-only-software front half.
            self.overload.enter_drain()
        if self.grpc is not None:
            await self.grpc.stop()
            self.grpc = None
        await self.console.stop()
        await self.api.stop()
        await self.match_registry.stop_all(grace)
        self.leaderboard_scheduler.stop()
        self.google_refund_scheduler.stop()
        # In-flight cohorts publish inside the grace window: the
        # delivery loop is still live, so poll the pipeline until it
        # empties or the deadline passes. (The journal's
        # unpublished-match records cover whatever remains.)
        depth = getattr(self.matchmaker.backend, "pipeline_depth", None)
        if depth is not None and grace:
            while depth() and loop.time() < deadline:
                await asyncio.sleep(0.05)
        self.matchmaker.stop()
        if self.recovery is not None:
            if self._release_held is not None:
                self._release_held.cancel()
            self.recovery.held.save(self.session_registry.all())
        retry_after = max(1.0, float(grace))
        for session in self.session_registry.all():
            await session.close(
                "server shutting down",
                code=1012,  # Service Restart
                kind="shutdown",
                retry_after_sec=retry_after,
            )
        await self.api.wait_closed()
        self.tracker.stop()
        if self.runtime is not None:
            await self.runtime.shutdown()
        if self.recovery is not None:
            # Drain-to-durable tail: flush the journal and write one
            # final checkpoint so the next boot replays nothing.
            await self.recovery.shutdown()
        if self._db_connected:
            # Commit the queued write units BEFORE close(); deadline-
            # bounded with a 1s floor so even grace=0 stops commit the
            # backlog of an idle queue.
            budget = max(1.0, deadline - loop.time())
            if not await self.db.drain_writes(budget):
                self.logger.warn(
                    "write queue not fully drained within the"
                    " shutdown grace; remaining units will be"
                    " rejected",
                    budget_s=round(budget, 2),
                )
            await self.db.close()
            self._db_connected = False
        self.logger.info("server stopped")

    def issue_session(self, user_id: str, username: str) -> str:
        """Create a session token and register it with the cache (the
        auth core's tail; for tests and operator tooling)."""
        from .api import session_token

        token, claims = session_token.generate(
            self.config.session.encryption_key,
            user_id,
            username,
            self.config.session.token_expiry_sec,
        )
        self.session_cache.add(user_id, claims.expires_at, claims.token_id)
        return token


async def _amain(config: Config):
    # Handlers first: a signal that lands while the server boots (or
    # right after its "server listening" line) still stops it cleanly.
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    server = NakamaServer(config)
    await server.start()
    await stop.wait()
    await server.stop()


def main(argv: list[str] | None = None):
    import sys

    config = parse_args(argv if argv is not None else sys.argv[1:])
    for warning in config.check():
        print(f"config warning: {warning}")
    asyncio.run(_amain(config))


if __name__ == "__main__":
    main()
