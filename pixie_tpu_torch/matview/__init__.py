"""Materialized views: standing queries with incremental O(delta) refresh.

A dashboard re-runs the same PxL script every few seconds over a sliding
window; without views the engine rescans the whole window per run.  This
package keeps the reusable part of such queries — the compiled plan prefix
scan→filter→map→partial-agg — materialized as value-keyed partial-aggregate
state, folds only rows appended since the last refresh (table.delta
cursors), and answers a matching query by finalizing the standing state:
O(new rows) per run instead of O(window), the KV-cache shape of an
inference stack applied to telemetry queries.

  registry.py    — canonical view keys over plan prefixes (shared by the
                   broker-side matcher and the agent-side maintainer)
  maintainer.py  — per-store standing-view state: registration on first
                   sight, O(delta) refresh on later sights / cron ticks,
                   invalidation (schema change, retention trimming, dead
                   cursors), LRU state-budget eviction

Env flags: PL_MATVIEW_ENABLED, PL_MATVIEW_MAX_STATE_MB,
PL_MATVIEW_REFRESH_S (see maintainer.py).

Copied from the reference package (pixie_tpu/matview/); maintainer.py says
what the port leaves out.
"""
from pixie_tpu_torch.matview.maintainer import MatViewManager
from pixie_tpu_torch.matview.registry import ViewPrefix, match_prefix, view_key

__all__ = ["MatViewManager", "ViewPrefix", "match_prefix", "view_key"]
