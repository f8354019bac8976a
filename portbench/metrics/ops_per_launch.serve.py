"""Tenants' crypto ops a fused launch of the cross-tenant coalescer."""


def read(run):
    serve = run.serve or {}
    if not serve.get("fused_launches"):
        return None
    return serve["fused_ops"] / serve["fused_launches"]
