from .core.cli import main

raise SystemExit(main())
