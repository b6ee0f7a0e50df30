"""Graphs per flush: the service's own request and flush counters over the
window, requests over flushes."""


def read(ctx):
    flushes = ctx.window.facts.get("flushes")
    if not flushes:
        return None
    return ctx.window.facts["requests"] / flushes
