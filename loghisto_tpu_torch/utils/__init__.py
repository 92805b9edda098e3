"""Host utilities of the port: process gauges, checkpoints and journals
(``utils.checkpoint``, ``utils.journal``)."""
