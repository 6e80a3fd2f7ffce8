"""The CARLA bridge (port of bridge/): the tick-synchronised runner that
couples the SFM core on the card to a world (CARLA through its RPC client,
or the in-process ``FakeWorld``), map extraction, and vehicle management.
``carla`` is imported lazily, inside the functions that need it."""
