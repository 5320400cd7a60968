"""views_per_s: replica views materialized over the window's whole time
(host clock); one rebuild of the swarm counts a view for each replica."""


def read(run):
    views = run.totals.get("views")
    return None if views is None else views / run.window_s
