"""``phase.sum_gravity_ms.galaxy``: ``phase.sum_gravity_ms`` in a cell whose
end-to-end metric besides the set-up is the device time a step
(``step_device_ms``), not the rate; read alike."""

from portbench.lib import manifest


def read(ctx):
    return manifest.load_module("metrics", "phase.sum_gravity_ms").read(ctx)
