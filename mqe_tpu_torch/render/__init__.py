"""Onboard cameras (analytic ray caster) and the host-side top-down renderer."""
