from tendermint_tpu_torch.cmd import main

raise SystemExit(main())
